"""Sharding rules for the param tree: the port of
``ray_tpu/parallel/sharding.py``.

The rules are the reference's, leaf for leaf: Megatron on ``tensor``
(attention heads and the FFN hidden dim), ZeRO on ``fsdp`` (the model
dim), experts on ``expert``, replication elsewhere. A spec is the port's
own ``PartitionSpec``, a tuple of axis names (or ``None``) per dim.

On a mesh of virtual ranks (``parallel.mesh``) partitioning changes no
value: ``shard_params`` places each leaf whole on the mesh's device and
records its ``NamedSharding`` on the tensor (``t.sharding``, where a JAX
array keeps its own), and a step over the mesh computes the one-device
step. ``context_parallel_attention`` gives the model an attention over
the mesh's ``seq`` axis: ring attention or Ulysses on the virtual ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.parallel.mesh import mesh_axis_size


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec


def _ax(mesh, name: str) -> Optional[str]:
    """Axis name if present in the mesh with size > 1, else None."""
    return name if mesh_axis_size(mesh, name) > 1 else None


def llama_param_specs(config: LlamaConfig, mesh) -> Dict[str, Any]:
    """PartitionSpecs for the stacked Llama param tree.

    Megatron layout on the ``tensor`` axis (attention heads + ffn hidden),
    ZeRO-style on ``fsdp`` (the model dim), replication elsewhere.
    """
    fsdp = _ax(mesh, "fsdp")
    tp = _ax(mesh, "tensor")
    if tp is not None and config.n_kv_heads % mesh_axis_size(mesh, "tensor"):
        raise ValueError(
            f"tensor axis ({mesh_axis_size(mesh, 'tensor')}) must divide "
            f"n_kv_heads ({config.n_kv_heads})")
    ep = _ax(mesh, "expert")
    if ep is not None and config.n_experts \
            and config.n_experts % mesh_axis_size(mesh, "expert"):
        raise ValueError(
            f"expert axis ({mesh_axis_size(mesh, 'expert')}) must divide "
            f"n_experts ({config.n_experts})")
    if config.n_experts:
        ffn_specs = {
            "router": P(None, None, None),
            "w_gate": P(None, ep, fsdp, tp),
            "w_up": P(None, ep, fsdp, tp),
            "w_down": P(None, ep, tp, fsdp),
        }
    else:
        ffn_specs = {
            "w_gate": P(None, fsdp, tp),
            "w_up": P(None, fsdp, tp),
            "w_down": P(None, tp, fsdp),
        }
    specs = {
        "embed": P(tp, fsdp),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, fsdp, tp),
            "wk": P(None, fsdp, tp),
            "wv": P(None, fsdp, tp),
            "wo": P(None, tp, fsdp),
            "ffn_norm": P(None, None),
            **ffn_specs,
        },
        "norm_f": P(None),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = P(fsdp, tp)
    return specs


def _tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure (a spec, a
    shape tuple or a tensor is a leaf)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def llama_param_shardings(config: LlamaConfig, mesh) -> Dict[str, Any]:
    return _tree_map(lambda s: NamedSharding(mesh, s),
                     llama_param_specs(config, mesh))


def batch_spec(mesh) -> PartitionSpec:
    """Global batch sharded over every data-like axis present."""
    axes = [a for a in ("data", "fsdp") if mesh_axis_size(mesh, a) > 1]
    if not axes:
        return P()
    # One axis is named as itself, as JAX's PartitionSpec normalizes it.
    return P(axes[0] if len(axes) == 1 else tuple(axes))


def batch_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_params(params, shardings):
    """Place (or re-place) a param tree on its shardings' mesh device:
    each leaf whole, with its ``NamedSharding`` recorded as
    ``leaf.sharding`` (a virtual mesh's partitioning changes no value)."""
    def place(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
        out = t.to(sh.mesh.device)
        if out is t:
            out = t.detach()
        out.sharding = sh
        return out

    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k]) for k, v in params.items()}
    return place(params, shardings)


def context_parallel_attention(mesh, seq_axis: str = "seq",
                               impl: str = "ring"):
    """Attention callable for context-parallel training: plug into
    ``LlamaConfig(attn_impl=...)`` / ``forward(attn_impl=...)`` and the
    model's attention runs sequence-parallel over ``mesh[seq_axis]``.
    ``impl="ring"`` rotates KV shards around the ring (the differentiable
    ``"lax"`` route); ``impl="ulysses"`` reshards into head-sharded
    full-sequence flash attention (B1, and B2/B3 under grad)."""
    if impl == "ulysses":
        from ray_tpu_torch.ops.ulysses import (
            ulysses_attention_global as _global)
    elif impl == "ring":
        from ray_tpu_torch.ops.ring_attention import (
            ring_attention_global as _global)
    else:
        raise ValueError(f"impl={impl!r}: expected 'ring' or 'ulysses'")

    def attn(q, k, v, causal=True, positions=None):
        return _global(q, k, v, mesh, causal=causal, seq_axis=seq_axis)

    return attn
