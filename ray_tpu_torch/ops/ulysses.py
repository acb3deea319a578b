"""Ulysses-style sequence parallelism, an all-to-all head/sequence
reshard: the port of ``ray_tpu/ops/ulysses.py``.

Where ring attention keeps the queries home and rotates the KV shards,
Ulysses reshards: each rank starts with every head of a sequence shard
[B, S/n, H, D], trades it for the whole sequence of a head shard
[B, S, H/n, D], runs flash attention there (exact, no online-softmax
recursion) and trades back. Parallelism is capped by the head count: n
must divide both H and H_kv.

On virtual ranks (``parallel.mesh``) the inputs are rank-major
``[n, B, S/n, H, D]``, and each of the reference's two ``all_to_all``s
(XLA collectives, not Pallas kernels) is a transposition of that tensor,
to ``[n, B, S, H/n, D]`` and back. In between,
``ops.attention.flash_attention`` runs on ``[n * B, S, H/n, D]``: kernel
B1, and B2/B3 in the backward pass (their plain versions on the CPU).
GQA heads are repeated after the reshard, as in the reference. Unbound
(no mesh, or an axis of size 1) it is exact local flash attention on
``[B, S, H, D]``. One rank per process (a group's mesh) comes with the
mesh across processes, which carries the all-to-all between them.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.ring_attention import shard_sequence, \
    unshard_sequence
from ray_tpu_torch.parallel.mesh import mesh_axis_size


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=-2)


def _to_heads(x: torch.Tensor) -> torch.Tensor:
    """[n, B, S/n, H, D] -> [n, B, S, H/n, D]: rank r gets head chunk r
    of every rank's sequence shard, in rank order along the sequence."""
    n, B, Sl, H, D = x.shape
    x6 = x.reshape(n, B, Sl, n, H // n, D)          # [src, B, s, dst, h, D]
    return x6.permute(3, 1, 0, 2, 4, 5).reshape(n, B, n * Sl, H // n, D)


def _to_sequence(x: torch.Tensor) -> torch.Tensor:
    """[n, B, S, H/n, D] -> [n, B, S/n, H, D], the inverse."""
    n, B, S, Hn, D = x.shape
    x6 = x.reshape(n, B, n, S // n, Hn, D)          # [head r, B, seq j, s]
    return x6.permute(2, 1, 3, 0, 4, 5).reshape(n, B, S // n, n * Hn, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, axis_name: str = "sp",
                      mesh=None) -> torch.Tensor:
    """Ulysses attention over ``mesh[axis_name]`` on rank-major
    [n, B, S/n, H, D] shards; k and v may carry fewer (grouped-query)
    heads. n must divide both head counts."""
    n = 1 if mesh is None else mesh_axis_size(mesh, axis_name)
    H, Hkv = q.shape[-2], k.shape[-2]
    if n == 1:
        if mesh is not None:
            return ulysses_attention(q[0], k[0], v[0], causal)[None]
        return flash_attention(q, _repeat_heads(k, H // Hkv),
                               _repeat_heads(v, H // Hkv), causal)
    if mesh.group is not None:
        raise NotImplementedError(
            "Ulysses with one rank per process needs an all-to-all between "
            "the processes; it comes with the mesh across processes")
    if H % n or Hkv % n:
        raise ValueError(
            f"ulysses: sequence-axis size {n} must divide n_heads={H} "
            f"and n_kv_heads={Hkv} (use ring attention otherwise)")
    B = q.shape[1]
    qg, kg, vg = _to_heads(q), _to_heads(k), _to_heads(v)
    kg = _repeat_heads(kg, H // Hkv)
    vg = _repeat_heads(vg, H // Hkv)
    S = qg.shape[2]
    out = flash_attention(*(t.reshape(n * B, S, t.shape[3], t.shape[4])
                            for t in (qg, kg, vg)), causal)
    return _to_sequence(out.reshape(n, B, S, H // n, q.shape[-1]))


def ulysses_attention_global(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mesh, causal: bool = True,
                             seq_axis: str = "sp") -> torch.Tensor:
    """Global view: whole [B, S, H, D] inputs, sharded on the sequence
    over ``mesh[seq_axis]``'s virtual ranks, whole again after."""
    n = mesh_axis_size(mesh, seq_axis)
    if n == 1:
        return ulysses_attention(q, k, v, causal=causal)
    out = ulysses_attention(shard_sequence(q, n), shard_sequence(k, n),
                            shard_sequence(v, n), causal=causal,
                            axis_name=seq_axis, mesh=mesh)
    return unshard_sequence(out)
