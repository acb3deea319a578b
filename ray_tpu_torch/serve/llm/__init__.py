"""Continuous-batching LLM serving: dense and paged KV layouts, the prefix
cache and host KV tier, preemption, speculative decoding, and the
disaggregated prefill/decode tier (``disagg``)."""

from ray_tpu_torch.serve.llm.deployment import LLMServer
from ray_tpu_torch.serve.llm.disagg import (
    DecodeServer, KVExporter, KVImporter, PrefillServer,
)
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, LLMEngine, Request, RequestHandle, static_batch_generate,
)

__all__ = ["DecodeServer", "EngineConfig", "KVExporter", "KVImporter",
           "LLMEngine", "LLMServer", "PrefillServer", "Request",
           "RequestHandle", "static_batch_generate"]
