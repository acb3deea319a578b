"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch``, never
``jax`` and nothing of ``ray_tpu``. Tensor code is PyTorch; each TPU
kernel on a ported path is a kernel written by hand for ``sm_90a`` under
``ops/csrc/``, built at first use. Entry points run on the card unless
the caller passes ``device="cpu"`` (the tests do; the kernels' plain
versions run there).

Ported so far: the serving data plane on the dense and paged KV layouts
with speculative decoding and the disaggregated prefill/decode tier
(``models.llama``, ``ops.attention``, ``serve.llm``), the serving
engine's metrics, spans and cost meters (``observability``,
``util.metrics``, ``util.tracing``), training on one device
(``ops.fused_loss``, ``parallel.train_step``, the attention's backward
kernels) and ZeRO over ring collectives (``parallel.zero``,
``util.collective``).
"""

__version__ = "0.1.0"
