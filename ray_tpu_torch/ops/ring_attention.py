"""Ring attention, context parallelism over a mesh axis: the port of
``ray_tpu/ops/ring_attention.py``.

The sequence is sharded over the n ranks of a mesh axis. Each rank keeps
its query shard and accumulates its queries' attention over the whole
sequence with an online softmax while the key/value shards travel around
the ring, one hop a step, so the [S, S] score matrix never exists.

Forms (``parallel.mesh``):

- **virtual ranks** (a mesh of n entries of one device): q, k, v are
  rank-major ``[n, B, S/n, H, D]``, rank r's shard ``x[r]``, and so is the
  result;
- **one rank per process** (a mesh from ``get_group_mesh`` on a ``cuda``
  group): q, k, v are this rank's ``[B, S/n, H, D]`` and the hops are C1's
  rank form over the group;
- **unbound** (no mesh, or an axis of size 1): exact local attention on
  ``[B, S, H, D]``, as the reference outside ``shard_map``.

Routes (``impl``):

- ``"lax"``: the hop is a rotation of the rank axis written as a tensor
  op (``torch.roll``), the counterpart of XLA's ``ppermute``;
  differentiable, so it is what training uses. Each step's block runs
  under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
  Virtual ranks only.
- ``"cuda"`` (and ``"pallas"``, and ``"auto"`` on a CUDA tensor): each
  step issues ``start_ring_permute`` on K and on V, computes the block,
  then ``wait_ring_permute``: kernel C1 (``util/collective/ring.py``) on
  the comm stream under the block's products, 2n launches a call.
  Forward only, like ``pallas_call``: under autograd, with an input that
  requires grad, it raises. On a CPU tensor ``"pallas"`` and
  ``"pallas_interpret"`` run the same schedule through C1's plain version.
  ``"auto"`` on a CPU tensor is ``"lax"``.

The block's products stay ``torch.einsum``, as the reference's are einsums
outside any Pallas kernel; both operands are upcast to f32 (exact
products, f32 sums: the reference's ``preferred_element_type=f32``) and P
is rounded to V's type before P.V. The causal mask uses the reference's
positions, ``my * Sl + row`` against ``src * Sl + row``; fully masked rows
divide by 1. The two routes move the same bytes into the same block
math, so their outputs are equal bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel.mesh import mesh_axis_size

NEG = -1e30


def rotate(x: torch.Tensor) -> torch.Tensor:
    """One hop of the ring on rank-major x [n, ...]: ``out[r] = x[r - 1]``
    (the rank axis rotated; differentiable)."""
    return torch.roll(x, 1, 0)


def _route(impl: str, device: torch.device) -> Optional[str]:
    """None for the rotation route, else the ring's impl for C1."""
    valid = ("lax", "auto", "cuda", "pallas", "pallas_interpret")
    if impl not in valid:
        raise ValueError(f"impl must be one of {valid}, got {impl!r}")
    if impl == "lax" or (impl == "auto" and device.type != "cuda"):
        return None
    if impl == "pallas_interpret":
        return "plain"
    if impl == "pallas":
        return "cuda" if device.type == "cuda" else "plain"
    return "cuda"


def _block(q, k_cur, v_cur, my, src, m, l, acc, causal, scale):
    """One ring step on rank-major shards: q [R, B, Sl, H, D] against the
    kv shard each rank holds (from rank ``src[r]``), online-softmax
    style; m, l [R, B, H, Sl] and acc [R, B, Sl, H, D] in f32."""
    Sl = q.shape[2]
    s = torch.einsum("rbqhd,rbkhd->rbhqk", q.float(), k_cur.float()) * scale
    if causal:
        rows = torch.arange(Sl, device=q.device)
        q_pos = (my[:, None] * Sl + rows)[:, :, None]
        k_pos = (src[:, None] * Sl + rows)[:, None, :]
        mask = (q_pos >= k_pos)[:, None, None]           # [R, 1, 1, Sl, Sl]
        s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1)
    pv = torch.einsum("rbhqk,rbkhd->rbqhd", p.to(v_cur.dtype).float(),
                      v_cur.float())
    acc_new = acc * alpha.transpose(-1, -2)[..., None] + pv
    return m_new, l_new, acc_new


def _attend(q, k, v, my, n, causal, start, wait, remat):
    """The n ring steps on rank-major [R, B, Sl, H, D] shards; ``start``
    issues a hop of a shard and ``wait`` returns the left neighbour's."""
    R, B, Sl, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    m = torch.full((R, B, H, Sl), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((R, B, H, Sl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((R, B, Sl, H, D), dtype=torch.float32,
                      device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        src = (my - step) % n
        kh, vh = start(k_cur), start(v_cur)
        if remat:
            m, l, acc = checkpoint(_block, q, k_cur, v_cur, my, src, m, l,
                                   acc, causal, scale, use_reentrant=False)
        else:
            m, l, acc = _block(q, k_cur, v_cur, my, src, m, l, acc, causal,
                               scale)
        k_cur, v_cur = wait(kh), wait(vh)
    l_safe = torch.where(l == 0.0, 1.0, l)               # fully-masked rows
    out = acc / l_safe.transpose(-1, -2)[..., None]
    return out.to(q.dtype)


def _refuse_grad(impl: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ring_attention(impl={impl!r}) runs C1's split-phase hops, "
            "which are forward only (as pallas_call has no autodiff rule); "
            "use impl='lax' under autograd")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, axis_name: str = "sp",
                   impl: str = "lax", mesh=None) -> torch.Tensor:
    """Ring attention over ``mesh[axis_name]`` (see the module docstring
    for the forms and routes). Without a mesh, or on an axis of size 1,
    exact local attention."""
    n = 1 if mesh is None else mesh_axis_size(mesh, axis_name)
    rank_form = mesh is not None and mesh.group is not None
    if n == 1:
        from ray_tpu_torch.models.llama import xla_attention

        if mesh is None or rank_form:
            return xla_attention(q, k, v, causal=causal)
        return xla_attention(q[0], k[0], v[0], causal=causal)[None]
    from ray_tpu_torch.util.collective.ring import (
        start_ring_permute, wait_ring_permute)

    if rank_form:
        group = mesh.group
        if _route(impl, group.device) is None:
            raise ValueError(
                f"impl={impl!r}: with one rank per process the hops are "
                "C1's rank form; use impl='cuda'")
        _refuse_grad(impl, q, k, v)
        if len(mesh.axis_names) != 1:
            raise ValueError("a group's mesh has one axis")
        my = torch.tensor([group.rank], device=q.device)

        def start(x):
            # The group runs what its device gives: C1's rank form on the
            # card, the plain hop over the gathered stack on the CPU.
            return start_ring_permute(x[0], impl="auto", group=group)

        def wait(h):
            return wait_ring_permute(h)[None]

        return _attend(q[None], k[None], v[None], my, n, causal, start,
                       wait, remat=False)[0]
    if q.shape[0] != n:
        raise ValueError(f"ring_attention over {axis_name!r} of size {n} "
                         f"takes rank-major [{n}, B, S/n, H, D], got "
                         f"{tuple(q.shape)}")
    my = torch.arange(n, device=q.device)
    ring_impl = _route(impl, q.device)
    if ring_impl is None:
        return _attend(q, k, v, my, n, causal, rotate, lambda x: x,
                       remat=True)
    _refuse_grad(impl, q, k, v)
    group = mesh.ring_group(axis_name) if ring_impl == "cuda" else None

    def start(x):
        return start_ring_permute(x, impl=ring_impl, group=group)

    return _attend(q, k, v, my, n, causal, start, wait_ring_permute,
                   remat=False)


def shard_sequence(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, ...] -> rank-major [n, B, S/n, ...] (rank r: rows
    r*S/n .. (r+1)*S/n - 1), contiguous."""
    B, S = x.shape[0], x.shape[1]
    if S % n:
        raise ValueError(f"sequence of {S} does not split over {n} ranks")
    return x.reshape(B, n, S // n, *x.shape[2:]).transpose(0, 1) \
        .contiguous()


def unshard_sequence(x: torch.Tensor) -> torch.Tensor:
    """Rank-major [n, B, S/n, ...] -> [B, S, ...]."""
    n, B, Sl = x.shape[0], x.shape[1], x.shape[2]
    return x.transpose(0, 1).reshape(B, n * Sl, *x.shape[3:])


def ring_attention_global(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mesh, causal: bool = True,
                          seq_axis: str = "sp",
                          impl: str = "lax") -> torch.Tensor:
    """Global view: q, k, v are whole [B, S, H, D]; the sequence dim is
    sharded over ``mesh[seq_axis]``'s virtual ranks, the ring runs, and
    the result is whole again."""
    n = mesh_axis_size(mesh, seq_axis)
    if n == 1:
        return ring_attention(q, k, v, causal=causal, impl=impl)
    out = ring_attention(shard_sequence(q, n), shard_sequence(k, n),
                         shard_sequence(v, n), causal=causal,
                         axis_name=seq_axis, impl=impl, mesh=mesh)
    return unshard_sequence(out)
