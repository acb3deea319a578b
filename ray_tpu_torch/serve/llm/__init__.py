"""Continuous-batching LLM serving, dense KV layout."""

from ray_tpu_torch.serve.llm.deployment import LLMServer
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, LLMEngine, Request, RequestHandle, static_batch_generate,
)

__all__ = ["EngineConfig", "LLMEngine", "LLMServer", "Request",
           "RequestHandle", "static_batch_generate"]
