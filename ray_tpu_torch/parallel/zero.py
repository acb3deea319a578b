"""ZeRO data parallelism over a ring of n virtual ranks: the port of the
explicit route of ``ray_tpu/parallel/zero.py`` (``build_zero_train_step``).

Plain data parallelism allreduces full gradients and runs the same
optimizer update on every replica's full copy. ZeRO shards the update:

    allreduce(grads) ; full update            (every rank)
  -> reduce-scatter(grads) ; update on 1/n    (every rank)
  -> allgather(params)

with the same ring traffic (ring RS + ring AG = ring AR) but 1/n of the
optimizer work and moments per rank.

On one device the n ranks are virtual: every rank's copy of the
parameters is one row of a rank-major flat buffer ``[n, padded]`` (the
reference's ``ravel_pytree`` vector, zero padded to a multiple of
``n * 128``), rank r's parameter tree is a set of views into row r, and
the exchange runs through the ring collectives of
``ray_tpu_torch.util.collective`` (kernels C2 and C3, or C1 per hop under
``overlap``; their plain versions on the CPU). The semantics are the
reference's:

- the batch splits along dim 0 into n rank slices; each rank takes the
  loss and gradients of its own slice with its own copy of the params;
- the flat gradient is summed over ranks (not averaged), reduce-scattered
  so rank r owns chunk r;
- the optimizer updates each rank's 1/n shard;
- the allgather rebuilds every rank's copy;
- ``loss`` is the mean of the ranks' losses and
  ``grad_norm = sqrt(sum over ranks of sum g^2)`` (summed in f32).

Under ``overlap=True`` the flat vector is cut into ``n_chunks`` chunks on
``n * 128`` boundaries and pipelined through the split-phase forms: chunk
c + 1's reduce-scatter hops and chunk c - 1's allgather hops are issued
on the group's comm stream while chunk c's optimizer math runs on the
current stream. The optimizer state is then chunk-major (chunk c's
slice of every rank's shard is its own tensor), so a state keeps the
layout of the first step that ran on it; a step of the other layout
raises. Numerics match the monolithic step to float tolerance: the
chunked rings re-associate the adds.

The reference jits one step and donates its state. Here the step runs
eagerly and updates in place: the rank copies, the shards and the
optimizer's moments are written where they lie, the gradient buffer is
reused (and clobbered by the in-place reduce-scatter), and the step
returns the same state, advanced.

``optimizer`` is a callable that builds a ``torch.optim`` optimizer over
a list of tensors (``functools.partial(torch.optim.Adam, lr=1e-2)``); the
first step on a state builds it over that state's shards.

``quantized_grads=True`` sends the gradient exchange over the int8 ring
(the weight allgather stays exact, C3 or C1 per hop): monolithic, the
f32 carry goes through ``quantized_ring_allreduce`` (C6, in place) and
rank r keeps chunk r of ITS row of the result, which has passed one more
int8 hop than the partial sums (as the reference's ``_my_shard``);
under ``overlap`` each chunk goes through the split-phase int8
reduce-scatter (C5 per hop). ``error_feedback=True`` (with
``quantized_grads`` and a state from ``create_zero_state(...,
error_feedback=True)``) adds the last step's residual ``ef`` to the
gradient before the exchange and keeps what this step's first int8
compression drops (``local_quantization_residual``, per chunk under
overlap). The int8 ring sends f32, so under ``quantized_grads`` the
gradient buffer is f32 and the carry is that buffer, in place. The
reduced shard is cast to the params' dtype for the torch optimizer (the
reference hands optax an f32 gradient when the carry is f32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.util.collective import (
    LANES, RingGroup, local_quantization_residual, quantized_ring_allreduce,
    ring_allgather, ring_allreduce, ring_reduce_scatter,
    start_quantized_ring_reduce_scatter, start_ring_allgather,
    start_ring_reduce_scatter, wait_quantized_ring_reduce_scatter,
    wait_ring_allgather, wait_ring_reduce_scatter,
)

Params = Dict[str, Any]
Factory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def _padded_len(size: int, n: int) -> int:
    group = n * LANES
    return -(-size // group) * group


def _paths(tree: Params, prefix: Tuple[str, ...] = ()):
    """(path, leaf) in sorted key order at every level: the order of the
    reference's ``ravel_pytree`` over dicts."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@dataclasses.dataclass
class ZeroTrainState:
    """Every rank's parameter copy, the optimizer over the rank shards,
    and the step count.

    ``flat`` is ``[n, padded]``: row r is rank r's copy of the flattened
    params (``rank_params(r)`` gives its tree of views). ``shards`` is
    ``[n, padded // n]``, the tensors the optimizer updates: rank r's
    1/n, in the layout of the first step run on this state (``layout``).
    ``optimizer`` is built by that step. ``grads`` is the gradient
    buffer ``[n, padded]`` the exchange runs in (the params' dtype, f32
    under ``quantized_grads``). ``ef`` is the error-feedback buffer
    ``[n, padded]`` f32 (row r rank r's), or None.
    """

    flat: torch.Tensor
    group: RingGroup
    make_optimizer: Factory
    spec: List[Tuple[Tuple[str, ...], torch.Size, int]]
    size: int
    step: int = 0
    optimizer: Optional[torch.optim.Optimizer] = None
    shards: Optional[torch.Tensor] = None
    layout: Optional[Tuple] = None
    opt_params: List[List[torch.Tensor]] = dataclasses.field(
        default_factory=list)
    grads: Optional[torch.Tensor] = None
    ef: Optional[torch.Tensor] = None

    def _tree(self, r: int, requires_grad: bool):
        tree: Params = {}
        leaves = []
        row = self.flat[r]
        for path, shape, off in self.spec:
            leaf = row[off:off + shape.numel()].view(shape)
            if requires_grad:
                leaf = leaf.detach().requires_grad_(True)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
            leaves.append(leaf)
        return tree, leaves

    def rank_params(self, r: int) -> Params:
        """Rank r's parameter tree: views into ``flat[r]``."""
        return self._tree(r, False)[0]

    @property
    def params(self) -> Params:
        """Rank 0's parameter tree (every rank holds the same values)."""
        return self.rank_params(0)


def create_zero_state(params: Params, optimizer: Factory,
                      group: RingGroup, error_feedback: bool = False
                      ) -> ZeroTrainState:
    """A ZeRO state on ``group.device``: ``params`` (a tree of tensors of
    one float dtype) flattened and copied to every rank's row, and the
    optimizer factory, which the first step applies to the rank shards
    (moments exist for 1/n of the params per rank, as in the reference).
    With ``error_feedback`` the state carries a zeroed f32 residual buffer
    ``ef`` [n, padded] for the int8 exchange."""
    spec, leaves, off = [], [], 0
    for path, leaf in _paths(params):
        spec.append((path, leaf.shape, off))
        leaves.append(leaf)
        off += leaf.numel()
    dtypes = {t.dtype for t in leaves}
    if len(dtypes) != 1 or not next(iter(dtypes)).is_floating_point:
        raise TypeError(f"ZeRO flattens every param into one vector and "
                        f"needs one float dtype, got "
                        f"{sorted(map(str, dtypes))}")
    n = group.n
    flat = torch.zeros((n, _padded_len(off, n)), dtype=leaves[0].dtype,
                       device=group.device)
    with torch.no_grad():
        flat[:, :off] = torch.cat(
            [t.detach().reshape(-1).to(group.device) for t in leaves])
    ef = (torch.zeros(flat.shape, dtype=torch.float32, device=group.device)
          if error_feedback else None)
    return ZeroTrainState(flat=flat, group=group, make_optimizer=optimizer,
                          spec=spec, size=off, ef=ef)


def _chunks(padded: int, n: int, n_chunks: int) -> List[int]:
    """The reference's overlap chunk sizes: boundaries on n * LANES
    multiples, so every chunk reduce-scatters to equal rank slices."""
    groups = padded // (n * LANES)
    n_c = max(1, min(n_chunks, groups))
    base, rem = divmod(groups, n_c)
    return [(base + (1 if i < rem else 0)) * n * LANES for i in range(n_c)]


def _build_optimizer(state: ZeroTrainState, layout: Tuple,
                     factory: Factory) -> None:
    """Give the state its optimizer in ``layout`` at its first step."""
    if factory is not state.make_optimizer:
        raise ValueError("the step was given another optimizer factory "
                         "than create_zero_state")
    if state.optimizer is not None:
        if state.layout != layout:
            raise ValueError(
                f"this state's optimizer holds the {state.layout[0]} layout "
                f"and cannot continue under {layout[0]}: do not toggle "
                f"overlap, n_chunks or the replicated update mid-run")
        return
    n, padded = state.group.n, state.flat.shape[1]
    flat = state.flat
    with torch.no_grad():
        if layout[0] == "replicated":
            state.opt_params = [[flat[r]] for r in range(n)]
        else:
            s = padded // n
            state.shards = shards = torch.empty(
                (n, s), dtype=flat.dtype, device=flat.device)
            sizes = list(layout[1:])
            state.opt_params = [[] for _ in range(n)]
            for r in range(n):
                off = opt_off = 0
                for size in sizes:
                    cs = size // n
                    src = off + r * cs
                    shards[r, opt_off:opt_off + cs] = flat[r, src:src + cs]
                    state.opt_params[r].append(
                        shards[r, opt_off:opt_off + cs])
                    off += size
                    opt_off += cs
    state.optimizer = factory([p for row in state.opt_params for p in row])
    state.layout = layout


def _rank_batches(batch: Dict[str, Any], n: int, device: torch.device
                  ) -> List[Dict[str, torch.Tensor]]:
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into {n} ranks")
    chunks = {k: v.chunk(n, dim=0) for k, v in batch.items()}
    return [{k: v[r] for k, v in chunks.items()} for r in range(n)]


def _local_grads(state: ZeroTrainState, loss_fn, batch: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None):
    """Every rank's loss and gradient of its own batch slice, the
    gradients flattened into ``state.grads[r]`` (of ``dtype``, by default
    the params'). Returns (mean loss, sum of squared gradients over
    ranks, f32)."""
    n = state.flat.shape[0]
    dtype = dtype or state.flat.dtype
    if state.grads is None or state.grads.dtype != dtype:
        state.grads = None
        state.grads = torch.zeros(state.flat.shape, dtype=dtype,
                                  device=state.flat.device)
    grads_buf = state.grads
    losses, sq = [], None
    for r, part in enumerate(_rank_batches(batch, n, state.flat.device)):
        tree, leaves = state._tree(r, True)
        loss = loss_fn(tree, part)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(t) if g is None else g
                     for g, t in zip(grads, leaves)]
            torch.cat([g.reshape(-1) for g in grads],
                      out=grads_buf[r, :state.size])
            part_sq = sum(g.float().square().sum() for g in grads)
        sq = part_sq if sq is None else sq + part_sq
        losses.append(loss.detach().float())
        del tree, leaves, grads, loss
    with torch.no_grad():
        grads_buf[:, state.size:].zero_()     # the in-place ring clobbers it
    return torch.stack(losses).mean(), sq


def _step_opt(state: ZeroTrainState, c: int,
              shard_grads: List[torch.Tensor]) -> None:
    """One optimizer step over chunk c of every rank (chunk 0 outside
    the overlap layout)."""
    params = [state.opt_params[r][c] for r in range(len(shard_grads))]
    for p, g in zip(params, shard_grads):
        p.grad = g
    state.optimizer.step()
    for p in params:
        p.grad = None


def build_zero_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: Factory,
    group: RingGroup,
    *,
    collective: str = "auto",
    overlap: bool = False,
    n_chunks: int = 4,
    quantized_grads: bool = False,
    error_feedback: bool = False,
) -> Callable[[ZeroTrainState, Dict[str, Any]],
              Tuple[ZeroTrainState, Dict]]:
    """Returns ``step(state, batch) -> (state, metrics)``: a data-parallel
    step with the weight update sharded over ``group``'s n ranks (see the
    module docstring). ``collective`` picks the ring: ``auto`` (the kernels
    on the card, the plain versions on the CPU), ``cuda`` or ``plain``.
    ``metrics`` holds ``loss`` and ``grad_norm`` (of the raw gradients) as
    f32 scalar tensors on the device and the new ``step``."""
    if error_feedback and not quantized_grads:
        raise ValueError(
            "error_feedback corrects compression error and needs "
            "quantized_grads=True (the exact exchange has no residual)")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    n = group.n

    # The int8 ring sends an f32 carry, so under quantized_grads the
    # gradient buffer is f32 and the exchange runs in it, in place: no
    # f32 copy of the [n, padded] gradients beside a buffer of the
    # params' dtype (the values are the same: bf16 -> f32 is exact).
    grad_dtype = torch.float32 if quantized_grads else None

    def feed_back(carry: torch.Tensor, ef: torch.Tensor) -> None:
        """Error feedback on a [n, m] slice of the f32 carry, in place:
        add the last residual, then keep what this exchange's first int8
        compression drops (n scales per rank), before the ring clobbers
        the carry."""
        carry += ef
        local_quantization_residual(carry.view(n, -1, LANES), n,
                                    out=ef.view(n, -1, LANES))

    def mono(state: ZeroTrainState) -> None:
        s = state.flat.shape[1] // n
        dtype = state.flat.dtype
        if quantized_grads:
            if error_feedback:
                feed_back(state.grads, state.ef)
            full = quantized_ring_allreduce(state.grads, "sum",
                                            impl=collective, group=group,
                                            donate=True)
            # Rank r's shard: chunk r of its own row (_my_shard).
            shards = [full[r, r * s:(r + 1) * s].to(dtype) for r in range(n)]
        else:
            gshard = ring_reduce_scatter(
                state.grads.view(n, n * s // LANES, LANES), "sum",
                impl=collective, group=group, donate=True)
            shards = [gshard[r].view(-1) for r in range(n)]
        _step_opt(state, 0, shards)
        ring_allgather(state.shards.view(n, s // LANES, LANES),
                       impl=collective, group=group,
                       out=state.flat.view(n, n, s // LANES, LANES))

    def pipelined(state: ZeroTrainState, sizes: List[int]) -> None:
        offs = [sum(sizes[:c]) for c in range(len(sizes))]

        def start_rs(c):
            # Under error feedback each chunk takes its residual, with n
            # scales of its own, just before its ring starts.
            sl = slice(offs[c], offs[c] + sizes[c])
            chunk = state.grads[:, sl]
            if error_feedback:
                feed_back(chunk, state.ef[:, sl])
            start = (start_quantized_ring_reduce_scatter if quantized_grads
                     else start_ring_reduce_scatter)
            return start(chunk.view(n, sizes[c] // LANES, LANES), "sum",
                         impl=collective, group=group, donate=True)

        wait = (wait_quantized_ring_reduce_scatter if quantized_grads
                else wait_ring_reduce_scatter)
        handles = [start_rs(0)]
        gathers = []
        opt_off = 0
        for c, size in enumerate(sizes):
            cs = size // n
            if c + 1 < len(sizes):
                # The next chunk's hops run beside this chunk's update.
                handles.append(start_rs(c + 1))
            gshard = wait(handles[c])
            _step_opt(state, c, [gshard[r].reshape(-1).to(state.flat.dtype)
                                 for r in range(n)])
            shard = state.shards[:, opt_off:opt_off + cs]
            out = state.flat[:, offs[c]:offs[c] + size]
            # The updated chunk leaves at once; its hops run beside the
            # next chunk's wait and update.
            gathers.append(start_ring_allgather(
                shard.view(n, cs // LANES, LANES), impl=collective,
                group=group, out=out.view(n, n, cs // LANES, LANES)))
            opt_off += cs
        for h in gathers:
            wait_ring_allgather(h)

    def step_fn(state: ZeroTrainState, batch: Dict[str, Any]
                ) -> Tuple[ZeroTrainState, Dict]:
        if state.group is not group:
            raise ValueError("the state lives on another RingGroup")
        if error_feedback and state.ef is None:
            raise ValueError(
                "error_feedback=True needs a state carrying an ef buffer; "
                "build it with create_zero_state(..., error_feedback=True)")
        padded = state.flat.shape[1]
        sizes = _chunks(padded, n, n_chunks) if overlap else [padded]
        _build_optimizer(state, ("overlap" if overlap else "monolithic",
                                 *sizes), optimizer)
        loss, sq = _local_grads(state, loss_fn, batch, grad_dtype)
        with torch.no_grad():
            if overlap:
                pipelined(state, sizes)
            else:
                mono(state)
        state.step += 1
        return state, {"loss": loss, "grad_norm": torch.sqrt(sq),
                       "step": state.step}

    return step_fn


def build_replicated_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: Factory,
    group: RingGroup,
    *,
    collective: str = "auto",
) -> Callable[[ZeroTrainState, Dict[str, Any]],
              Tuple[ZeroTrainState, Dict]]:
    """Plain data parallelism over ``group`` on a ZeRO state: the summed
    gradient reaches every rank through the ring allreduce (kernel C4 on
    the card), and every rank runs the same full update on its own copy.
    The yardstick ZeRO is held to: on a ring of two each element of the
    sum is one add either way, so the two agree bit for bit."""
    n = group.n

    def step_fn(state: ZeroTrainState, batch: Dict[str, Any]
                ) -> Tuple[ZeroTrainState, Dict]:
        if state.group is not group:
            raise ValueError("the state lives on another RingGroup")
        _build_optimizer(state, ("replicated",), optimizer)
        loss, sq = _local_grads(state, loss_fn, batch)
        with torch.no_grad():
            summed = ring_allreduce(state.grads, "sum", impl=collective,
                                    group=group)
            _step_opt(state, 0, [summed[r] for r in range(n)])
        state.step += 1
        return state, {"loss": loss, "grad_norm": torch.sqrt(sq),
                       "step": state.step}

    return step_fn
