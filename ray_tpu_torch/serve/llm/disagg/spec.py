"""Draft-model helpers for speculative decoding: the port of
``ray_tpu/serve/llm/disagg/spec.py``.

The engine accepts any (draft_params, draft_config) pair whose vocab
matches the target's; these helpers build the standard one, a shrunk
Llama sharing the target's vocab and rope geometry. Acceptance is
verified, so a bad draft costs speed, never correctness.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

__all__ = ["draft_config_for", "build_draft"]


def draft_config_for(config: Any, *, n_layers: int = 2, dim: int = 64,
                     n_heads: int = 4, n_kv_heads: int = 2,
                     hidden_dim: int = 128):
    """A small draft config compatible with ``config``: same vocab,
    sequence limit, rope theta, dtypes and attention route (the draft's
    cache rows cover the same positions), everything else shrunk."""
    return dataclasses.replace(
        config,
        n_layers=min(n_layers, config.n_layers),
        dim=min(dim, config.dim),
        n_heads=min(n_heads, config.n_heads),
        n_kv_heads=min(n_kv_heads, config.n_kv_heads),
        hidden_dim=min(hidden_dim, config.hidden_dim),
        n_experts=0,
    )


def build_draft(config: Any, seed: int = 0, draft_config: Any = None,
                device: Optional[Union[str, torch.device]] = None):
    """(draft_params, draft_config) for ``config``: random weights from
    ``init_params(seed)`` on ``device`` (default: the card). The
    production hook is a distilled checkpoint passed straight to
    ``LLMEngine(draft_params=..., draft_config=...)``."""
    from ray_tpu_torch.models.llama import init_params

    dc = draft_config or draft_config_for(config)
    return init_params(dc, seed, device), dc
