"""The serve knobs the paged engine reads, with the reference's names,
defaults and ``RAY_TPU_<name>`` environment overrides
(``ray_tpu/_private/config.py``). Only these knobs are here: the rest of
the reference's table, and its ``_system_config`` propagation through the
GCS, come with the port's runtime.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

_ENV_PREFIX = "RAY_TPU_"

# name -> (type, default)
_KNOBS: Dict[str, Tuple[type, Any]] = {
    # Rows per paged-KV block for engines built without kv_block_size.
    "serve_kv_block_size": (int, 16),
    # How long the interactive lane must stay starved before the
    # Hysteresis gate lets the engine checkpoint a batch decode.
    "serve_preempt_hold_s": (float, 0.25),
    # Least spacing between two batch-decode preemptions on one engine.
    "serve_preempt_cooldown_s": (float, 1.0),
    # Speculative depth: spec_k - 1 draft proposals verified per round.
    "serve_spec_k": (int, 4),
    # Host-RAM budget of the KV tier below the device pool.
    "serve_kv_host_tier_bytes": (int, 256 * 1024 * 1024),
    # PromoteCostModel, milliseconds: fixed cost of one promote, cost per
    # promoted block, and prefill cost per token (the recompute side).
    "serve_kv_adopt_cost_fixed_ms": (float, 2.0),
    "serve_kv_adopt_cost_per_block_ms": (float, 0.1),
    "serve_kv_prefill_cost_per_token_ms": (float, 0.05),
}


class _Config:
    """Resolved view: ``RAY_TPU_<name>`` in the environment, else the
    default. Read at each access, as the reference does."""

    def get(self, name: str) -> Any:
        type_, default = _KNOBS[name]
        env_val = os.environ.get(_ENV_PREFIX + name)
        if env_val is not None:
            return type_(env_val)
        return default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None


GlobalConfig = _Config()
