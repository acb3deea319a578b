"""The serve knobs the paged engine, its disaggregated tier and its
observability hooks read, with the reference's names, defaults and
``RAY_TPU_<name>`` environment overrides (``ray_tpu/_private/config.py``).
Only these knobs are here: the rest of the reference's table, and its
``_system_config`` propagation through the GCS, come with the port's
runtime.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {bool: _parse_bool}

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
    # Cap on the (stable_hash, depth) heads one replica publishes to the
    # cluster-wide prefix index (hottest first).
    "serve_prefix_index_max_heads": (int, 512),
    # Per-request cost accounting on LLM engines (RequestMeter, tenant
    # ledger); off = the unmetered engine.
    "serve_accounting_instrumentation": (bool, True),
    # Distinct tenant rows a TenantLedger holds; overflow folds into
    # "__other__".
    "serve_accounting_max_tenants": (int, 64),
    # Per-lane TTFT / TPOT targets in ms ("lane=ms,...", "*" the default
    # lane; a bare number applies to every lane).
    "serve_slo_ttft_ms": (str, "interactive=500,*=2000"),
    "serve_slo_tpot_ms": (str, "interactive=200,*=1000"),
    # Share of requests per lane that must meet their targets.
    "serve_slo_objective": (float, 0.99),
    # Fast and slow windows of the multi-window burn rate, the fast burn
    # that fires (with the slow one >= 1), and the least fast-window
    # samples trusted.
    "serve_slo_burn_fast_window_s": (float, 60.0),
    "serve_slo_burn_slow_window_s": (float, 3600.0),
    "serve_slo_burn_threshold": (float, 10.0),
    "serve_slo_min_samples": (int, 3),
}


class _Config:
    """Resolved view: ``RAY_TPU_<name>`` in the environment, else the
    default. Read at each access, as the reference does."""

    def get(self, name: str) -> Any:
        type_, default = _KNOBS[name]
        env_val = os.environ.get(_ENV_PREFIX + name)
        if env_val is not None:
            return _PARSERS.get(type_, type_)(env_val)
        return default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None


GlobalConfig = _Config()
