"""Pipeline parallelism over a mesh axis: the port of
``ray_tpu/parallel/pipeline.py``.

The reference's GPipe schedule, on the ranks of the mesh's ``pipe`` axis:
rank s holds stage s's parameters (a tree stacked ``[P, ...]``), the
microbatches ``[M, mb, ...]`` enter at stage 0, and each of the M + P - 1
ticks runs every stage once, bubbles included, then hands each stage's
output to the next stage. The outputs are the last stage's, in
microbatch order (what the reference's ``psum`` over the axis leaves).

On virtual ranks the ticks are a Python loop, and each tick runs
``stage_fn`` once per stage, also in a loop: ``torch.func.vmap`` cannot
map over flash attention's ``autograd.Function``. The hand-off is the
rank-axis rotation of ring attention's ``"lax"`` route
(``ops.ring_attention.rotate``) on the stages' stacked outputs, so the
function is differentiable end to end: autograd through it is the
reverse schedule. The backward pass reaches every stage call of every
tick but the last (their outputs are stacked for the rotation), and the
last stage's call of the last tick: P * (M + P - 2) + 1 calls, the
bubbles' with zero gradients, as the reference's transposed scan runs
them.

Bubble fraction is the usual (P-1)/(M+P-1): pick M >= 4*P for <20%.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.ops.ring_attention import rotate
from ray_tpu_torch.parallel.mesh import mesh_axis_size


def _stage(tree: Any, s: int) -> Any:
    if isinstance(tree, dict):
        return {k: _stage(v, s) for k, v in tree.items()}
    return tree[s]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``stage_fn`` P times (one stage per rank along ``axis``).

    stage_params: a tree (dicts of tensors) with leaves stacked [P, ...].
    x: microbatched input [M, mb, ...]. Returns [M, mb, ...] outputs.
    """
    n_stages = mesh_axis_size(mesh, axis)
    if mesh.group is not None:
        raise NotImplementedError(
            "a pipeline with one stage per process needs its hand-off "
            "between the processes; it comes with the mesh across "
            "processes")
    params = [_stage(stage_params, s) for s in range(n_stages)]
    m = x.shape[0]
    recv = torch.zeros((n_stages,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    ys = [None] * m
    for t in range(m + n_stages - 1):
        # Stage 0 ingests microbatch t (the last one again past M, which
        # no later tick reads); the others take the previous stage's.
        outs = [stage_fn(params[s], x[min(t, m - 1)] if s == 0 else recv[s])
                for s in range(n_stages)]
        if t >= n_stages - 1:
            ys[t - (n_stages - 1)] = outs[-1]
        if t < m + n_stages - 2:
            recv = rotate(torch.stack(outs))
    return torch.stack(ys)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...] (B must divide evenly)."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by M={n_microbatches}")
    return x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
