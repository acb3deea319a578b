"""Continuous-batching LLM serving: dense and paged KV layouts, the prefix
cache and the KV tiers (host RAM, then the object store), preemption,
speculative decoding, the disaggregated prefill/decode tier (``disagg``),
and the Serve side: ``LLMServer`` as a replica (``build_llm_app``), the
queue-depth and cache-aware ``LLMRouter`` in front of N replicas
(``build_routed_llm_app``) and the two-pool disaggregated app
(``build_disagg_llm_app``)."""

from ray_tpu_torch.serve.llm.deployment import LLMServer, build_llm_app
from ray_tpu_torch.serve.llm.disagg import (
    DecodeServer, KVExporter, KVImporter, PrefillServer,
    build_disagg_llm_app,
)
from ray_tpu_torch.serve.llm.engine import (
    EngineConfig, LLMEngine, Request, RequestHandle, static_batch_generate,
)
from ray_tpu_torch.serve.llm.kv_cache import (
    BlockAllocator, KVPrefix, KVState, KVTierManager, PrefixCache,
    PromoteCostModel, TierHit, stable_hash_prefix,
)
from ray_tpu_torch.serve.llm.router import LLMRouter, build_routed_llm_app

__all__ = [
    "BlockAllocator", "DecodeServer", "EngineConfig", "KVExporter",
    "KVImporter", "KVPrefix", "KVState", "KVTierManager", "LLMEngine",
    "LLMRouter", "LLMServer", "PrefillServer", "PrefixCache",
    "PromoteCostModel", "Request", "RequestHandle", "TierHit",
    "build_disagg_llm_app", "build_llm_app", "build_routed_llm_app",
    "stable_hash_prefix", "static_batch_generate",
]
