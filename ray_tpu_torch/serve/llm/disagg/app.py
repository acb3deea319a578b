"""Disaggregated serving composition: Router(Prefill, Decode), the port's
copy of ``ray_tpu/serve/llm/disagg/app.py``.

``build_disagg_llm_app`` is the disagg twin of
``serve.llm.build_routed_llm_app``: two independently-sized replica
pools behind the lane-aware router. Short prompts go straight to the
decode pool (their prefill is cheap); prompts at or past
``prefill_threshold`` tokens take the two-hop path — prefill replica
exports KV, decode replica adopts it, payload by ObjectRef (the
prefill replica's result is stored once, as its call's return value, and
the decode replica gets it from the object store).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["build_disagg_llm_app"]


def build_disagg_llm_app(model_config: Any = None,
                         engine_config: Any = None, *,
                         name: str = "llm",
                         prefill_replicas: int = 1,
                         decode_replicas: int = 1,
                         prefill_engine_config: Any = None,
                         prefill_threshold: int = 256,
                         speculative: Any = None,
                         num_gpus: float = 0,
                         max_ongoing_requests: int = 32,
                         init_seed: int = 0,
                         quantize: Optional[str] = None,
                         params_loader: Optional[Any] = None,
                         probe_interval_s: Optional[float] = None,
                         device: Optional[str] = None):
    """Bind the disaggregated tier as one Serve application.

    ``engine_config`` shapes the decode pool; ``prefill_engine_config``
    (default: same config) shapes the prefill pool — both must be
    paged, and the prefill pool needs ``prefix_cache=True`` (chunked
    long-prompt admission hands off through it). ``speculative`` is
    forwarded to the decode pool only: the draft model speeds decoding
    and has nothing to do during prefill. ``num_gpus`` is each engine
    replica's share of the card; ``device`` is bound with their
    arguments (``"cpu"`` on a host without a card).
    """
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm.deployment import _device_kw, _plain
    from ray_tpu_torch.serve.llm.disagg.decode import DecodeServer
    from ray_tpu_torch.serve.llm.disagg.prefill import PrefillServer
    from ray_tpu_torch.serve.llm.router import LLMRouter

    common: Dict[str, Any] = dict(
        model_config=_plain(model_config), init_seed=init_seed,
        quantize=quantize, params_loader=params_loader,
        **_device_kw(device))
    decode_dep = serve.deployment(
        DecodeServer, name=f"{name}-decode",
        num_replicas=int(decode_replicas), num_gpus=num_gpus,
        max_ongoing_requests=max_ongoing_requests)
    decode_app = decode_dep.bind(
        engine_config=_plain(engine_config),
        speculative=speculative, **common)
    prefill_dep = serve.deployment(
        PrefillServer, name=f"{name}-prefill",
        num_replicas=int(prefill_replicas), num_gpus=num_gpus,
        max_ongoing_requests=max_ongoing_requests)
    prefill_app = prefill_dep.bind(
        engine_config=_plain(prefill_engine_config
                             if prefill_engine_config is not None
                             else engine_config),
        **common)
    router_dep = serve.deployment(
        LLMRouter, name=f"{name}-router", num_replicas=1,
        max_ongoing_requests=max(64, max_ongoing_requests * 4))
    return router_dep.bind(decode_app,
                           probe_interval_s=probe_interval_s,
                           prefill_handle=prefill_app,
                           prefill_threshold=prefill_threshold)
