"""Disaggregated LLM serving: prefill and decode on separate engines, the
port's copy of ``ray_tpu/serve/llm/disagg``.

- :class:`PrefillServer` runs prefill + the first sampled token and
  exports the sequence as a
  :class:`~ray_tpu_torch.serve.llm.kv_cache.KVState` (CPU tensors).
- :class:`DecodeServer` adopts the blocks into its own pool —
  all-or-nothing — and continues decoding, token for token what one
  engine would produce.
- :class:`KVExporter` / :class:`KVImporter` are the two halves of that
  migration over an engine.
- ``spec.py``: the draft-model helpers of speculative decoding, the
  decode side's speed lever.

The servers run in one process here; ``build_disagg_llm_app`` (two
replica pools behind the LLM router, the payload through the object
store) needs the port's runtime and comes with it.
"""

from ray_tpu_torch.serve.llm.disagg.decode import DecodeServer
from ray_tpu_torch.serve.llm.disagg.prefill import PrefillServer
from ray_tpu_torch.serve.llm.disagg.spec import build_draft, draft_config_for
from ray_tpu_torch.serve.llm.disagg.transfer import KVExporter, KVImporter

__all__ = ["DecodeServer", "KVExporter", "KVImporter", "PrefillServer",
           "build_draft", "draft_config_for"]
