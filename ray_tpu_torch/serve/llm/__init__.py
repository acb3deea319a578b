"""Continuous-batching LLM serving: dense and paged KV layouts, the prefix
cache and host KV tier, preemption and speculative decoding."""

from ray_tpu_torch.serve.llm.deployment import LLMServer
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, LLMEngine, Request, RequestHandle, static_batch_generate,
)

__all__ = ["EngineConfig", "LLMEngine", "LLMServer", "Request",
           "RequestHandle", "static_batch_generate"]
