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

One rank per process: given a ``CudaGroup`` (``util.collective``'s
``cuda`` backend; the ranks are processes, on the card GPU actors that
share it) each process holds its own rank r. The state's rows are then
the one row of rank r (``flat`` [1, padded], its shard, its optimizer
and its ``ef``); the rank takes rows r of the global batch (the order
of ``_rank_batches``); the exchanges are the group's rank forms (C2 and
C3, C1 per hop under overlap, C6, C5 in place per hop under quantized
overlap, C4 for the replicated step), whose rows are the virtual-rank
calls' bit for bit; the optimizer's chunks and layout are the same. The
n ranks' losses and squared gradient sums are gathered through the group
and folded in rank order on the device, as the virtual-rank step folds
them, so ``loss``, ``grad_norm`` and every rank's params equal the
virtual-rank step's bit for bit. (The reference's ``pmean``/``psum`` of
them are XLA collectives, not kernels; the host-level gather stands in.)

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
    LANES, local_quantization_residual, quantized_ring_allreduce,
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


def _stacked(group) -> bool:
    """Whether ``group`` plays every rank in this process (a RingGroup),
    not one rank per process."""
    return not getattr(group, "rank_form", False)


def _local_ranks(group) -> List[int]:
    """The ranks this process holds, in row order."""
    return list(range(group.n)) if _stacked(group) else [group.rank]


@dataclasses.dataclass
class ZeroTrainState:
    """The parameter copies of the ranks this process holds, the optimizer
    over their shards, and the step count.

    ``ranks`` are those ranks: all n on a RingGroup, this process's own
    on a CudaGroup; row i of every buffer is rank ``ranks[i]``'s. ``flat``
    is ``[len(ranks), padded]``: each row a rank's copy of the flattened
    params (``rank_params(r)`` gives its tree of views). ``shards`` is
    ``[len(ranks), padded // n]``, the tensors the optimizer updates: each
    rank's 1/n, in the layout of the first step run on this state
    (``layout``). ``optimizer`` is built by that step. ``grads`` is the
    gradient buffer of flat's shape the exchange runs in (the params'
    dtype, f32 under ``quantized_grads``). ``ef`` is the error-feedback
    buffer of flat's shape, f32, or None.
    """

    flat: torch.Tensor
    group: Any
    make_optimizer: Factory
    spec: List[Tuple[Tuple[str, ...], torch.Size, int]]
    size: int
    ranks: List[int] = dataclasses.field(default_factory=list)
    step: int = 0
    optimizer: Optional[torch.optim.Optimizer] = None
    shards: Optional[torch.Tensor] = None
    layout: Optional[Tuple] = None
    opt_params: List[List[torch.Tensor]] = dataclasses.field(
        default_factory=list)
    grads: Optional[torch.Tensor] = None
    ef: Optional[torch.Tensor] = None

    def __post_init__(self):
        if not self.ranks:
            self.ranks = _local_ranks(self.group)

    def _tree(self, i: int, requires_grad: bool):
        tree: Params = {}
        leaves = []
        row = self.flat[i]
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
        """Rank r's parameter tree: views into its row of ``flat`` (a rank
        this process holds)."""
        if r not in self.ranks:
            raise ValueError(f"rank {r} is not held here (ranks "
                             f"{self.ranks})")
        return self._tree(self.ranks.index(r), False)[0]

    @property
    def params(self) -> Params:
        """The first held rank's parameter tree (every rank holds the same
        values)."""
        return self.rank_params(self.ranks[0])


def create_zero_state(params: Params, optimizer: Factory, group,
                      error_feedback: bool = False) -> ZeroTrainState:
    """A ZeRO state on ``group.device`` (a RingGroup of n virtual ranks,
    or a CudaGroup: this process's rank): ``params`` (a tree of tensors of
    one float dtype) flattened and copied to every held rank's row, and
    the optimizer factory, which the first step applies to the rank shards
    (moments exist for 1/n of the params per rank, as in the reference).
    With ``error_feedback`` the state carries a zeroed f32 residual buffer
    ``ef`` of flat's shape for the int8 exchange."""
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
    n, ranks = group.n, _local_ranks(group)
    flat = torch.zeros((len(ranks), _padded_len(off, n)),
                       dtype=leaves[0].dtype, device=group.device)
    with torch.no_grad():
        flat[:, :off] = torch.cat(
            [t.detach().reshape(-1).to(group.device) for t in leaves])
    ef = (torch.zeros(flat.shape, dtype=torch.float32, device=group.device)
          if error_feedback else None)
    return ZeroTrainState(flat=flat, group=group, make_optimizer=optimizer,
                          spec=spec, size=off, ranks=ranks, ef=ef)


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
    flat, rows = state.flat, len(state.ranks)
    with torch.no_grad():
        if layout[0] == "replicated":
            state.opt_params = [[flat[i]] for i in range(rows)]
        else:
            s = padded // n
            state.shards = shards = torch.empty(
                (rows, s), dtype=flat.dtype, device=flat.device)
            sizes = list(layout[1:])
            state.opt_params = [[] for _ in range(rows)]
            for i, r in enumerate(state.ranks):
                off = opt_off = 0
                for size in sizes:
                    cs = size // n
                    src = off + r * cs
                    shards[i, opt_off:opt_off + cs] = flat[i, src:src + cs]
                    state.opt_params[i].append(
                        shards[i, opt_off:opt_off + cs])
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


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """sum(g^2) in f32, through one f32 temporary squared in place."""
    t = g.float()
    return (t.square_() if t.data_ptr() != g.data_ptr() else t.square()).sum()


def _local_grads(state: ZeroTrainState, loss_fn, batch: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None):
    """Every held rank's loss and gradient of its own batch slice, the
    gradients flattened into its row of ``state.grads`` (of ``dtype``, by
    default the params'). Returns (mean loss over the n ranks, sum of
    squared gradients over the ranks in rank order, f32); the ranks held
    elsewhere send theirs through the group."""
    n = state.group.n
    dtype = dtype or state.flat.dtype
    if state.grads is None or state.grads.dtype != dtype:
        state.grads = None
        state.grads = torch.zeros(state.flat.shape, dtype=dtype,
                                  device=state.flat.device)
    grads_buf = state.grads
    parts = _rank_batches(batch, n, state.flat.device)
    losses, sqs = [], []
    for i, r in enumerate(state.ranks):
        tree, leaves = state._tree(i, True)
        row = grads_buf[i]
        views = [row[off:off + shape.numel()].view(shape)
                 for _, shape, off in state.spec]
        filled = [False] * len(leaves)

        def keep(j):
            # Each gradient goes into the buffer as autograd finishes it
            # and is freed: no gradient tree beside the buffer.
            def hook(leaf):
                views[j].copy_(leaf.grad)
                leaf.grad = None
                filled[j] = True
            return hook

        hooks = [leaf.register_post_accumulate_grad_hook(keep(j))
                 for j, leaf in enumerate(leaves)]
        loss = loss_fn(tree, parts[r])
        loss.backward()
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for j in range(len(views)):
                if not filled[j]:          # a leaf the loss does not use
                    views[j].zero_()
            sqs.append(sum(_square_sum(v) for v in views))
        losses.append(loss.detach().float())
        del tree, leaves, views, loss
    with torch.no_grad():
        grads_buf[:, state.size:].zero_()     # the in-place ring clobbers it
    if not _stacked(state.group):
        # Every rank's pair, in rank order, on the device.
        both = state.group.gather(torch.stack([losses[0], sqs[0]]))
        losses = [both[r, 0] for r in range(n)]
        sqs = [both[r, 1] for r in range(n)]
    sq = sqs[0]
    for part_sq in sqs[1:]:
        sq = sq + part_sq
    return torch.stack(losses).mean(), sq


def _step_opt(state: ZeroTrainState, c: int,
              shard_grads: List[torch.Tensor]) -> None:
    """One optimizer step over chunk c of every rank (chunk 0 outside
    the overlap layout)."""
    params = [state.opt_params[i][c] for i in range(len(shard_grads))]
    for p, g in zip(params, shard_grads):
        p.grad = g
    state.optimizer.step()
    for p in params:
        p.grad = None


def build_zero_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: Factory,
    group,
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
    module docstring; a RingGroup of virtual ranks, or a CudaGroup whose
    every rank calls the step with the same global batch). ``collective``
    picks the ring: ``auto`` (the kernels on the card, the plain versions
    on the CPU), ``cuda`` or ``plain`` (a CudaGroup takes ``auto`` or
    what its device runs). ``metrics`` holds ``loss`` and ``grad_norm``
    (of the raw gradients) as f32 scalar tensors on the device and the new
    ``step``."""
    if error_feedback and not quantized_grads:
        raise ValueError(
            "error_feedback corrects compression error and needs "
            "quantized_grads=True (the exact exchange has no residual)")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    n = group.n
    rank_form = not _stacked(group)

    def rows(t: torch.Tensor) -> torch.Tensor:
        """A [rows, ...] stack as the group's calls take it: the stack on
        a RingGroup, this rank's row on a CudaGroup."""
        return t[0] if rank_form else t

    def stack(t: torch.Tensor) -> torch.Tensor:
        """A call's result as a [rows, ...] stack."""
        return t[None] if rank_form else t

    # The int8 ring sends an f32 carry, so under quantized_grads the
    # gradient buffer is f32 and the exchange runs in it, in place: no
    # f32 copy of the [n, padded] gradients beside a buffer of the
    # params' dtype (the values are the same: bf16 -> f32 is exact).
    grad_dtype = torch.float32 if quantized_grads else None

    def feed_back(carry: torch.Tensor, ef: torch.Tensor) -> None:
        """Error feedback on a [rows, m] slice of the f32 carry, in place:
        add the last residual, then keep what this exchange's first int8
        compression drops (n scales per rank), before the ring clobbers
        the carry."""
        carry += ef
        local_quantization_residual(carry.view(carry.shape[0], -1, LANES),
                                    n, out=ef.view(ef.shape[0], -1, LANES))

    def mono(state: ZeroTrainState) -> None:
        s = state.flat.shape[1] // n
        dtype, L = state.flat.dtype, len(state.ranks)
        if quantized_grads:
            if error_feedback:
                feed_back(state.grads, state.ef)
            full = stack(quantized_ring_allreduce(
                rows(state.grads), "sum", impl=collective, group=group,
                donate=True))
            # Rank r's shard: chunk r of its own row (_my_shard).
            shards = [full[i, r * s:(r + 1) * s].to(dtype)
                      for i, r in enumerate(state.ranks)]
        else:
            # One rank per process: C2's result lands in the rank's own
            # chunk of its gradient buffer, which the staging has read.
            out = state.grads[0, group.rank * s:(group.rank + 1) * s].view(
                s // LANES, LANES) if rank_form else None
            gshard = stack(ring_reduce_scatter(
                rows(state.grads.view(L, n * s // LANES, LANES)), "sum",
                impl=collective, group=group, donate=True, out=out))
            shards = [gshard[i].view(-1) for i in range(L)]
        _step_opt(state, 0, shards)
        ring_allgather(rows(state.shards.view(L, s // LANES, LANES)),
                       impl=collective, group=group,
                       out=rows(state.flat.view(L, n, s // LANES, LANES)))

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
            return start(rows(chunk.view(L, sizes[c] // LANES, LANES)),
                         "sum", impl=collective, group=group, donate=True)

        wait = (wait_quantized_ring_reduce_scatter if quantized_grads
                else wait_ring_reduce_scatter)
        L = len(state.ranks)
        handles = [start_rs(0)]
        gathers = []
        opt_off = 0
        for c, size in enumerate(sizes):
            cs = size // n
            if c + 1 < len(sizes):
                # The next chunk's hops run beside this chunk's update.
                handles.append(start_rs(c + 1))
            gshard = stack(wait(handles[c]))
            _step_opt(state, c, [gshard[i].reshape(-1).to(state.flat.dtype)
                                 for i in range(L)])
            shard = state.shards[:, opt_off:opt_off + cs]
            out = state.flat[:, offs[c]:offs[c] + size]
            # The updated chunk leaves at once; its hops run beside the
            # next chunk's wait and update.
            gathers.append(start_ring_allgather(
                rows(shard.view(L, cs // LANES, LANES)), impl=collective,
                group=group, out=rows(out.view(L, n, cs // LANES, LANES))))
            opt_off += cs
        for h in gathers:
            wait_ring_allgather(h)

    def step_fn(state: ZeroTrainState, batch: Dict[str, Any]
                ) -> Tuple[ZeroTrainState, Dict]:
        if state.group is not group:
            raise ValueError(f"the state lives on another "
                             f"{type(group).__name__}")
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
    group,
    *,
    collective: str = "auto",
) -> Callable[[ZeroTrainState, Dict[str, Any]],
              Tuple[ZeroTrainState, Dict]]:
    """Plain data parallelism over ``group`` on a ZeRO state: the summed
    gradient reaches every rank through the ring allreduce (kernel C4 on
    the card; with a CudaGroup its rank form, in place in the rank's
    gradient buffer), and every rank runs the same full update on its own
    copy. The yardstick ZeRO is held to: on a ring of two each element of
    the sum is one add either way, so the two agree bit for bit."""
    rank_form = not _stacked(group)

    def step_fn(state: ZeroTrainState, batch: Dict[str, Any]
                ) -> Tuple[ZeroTrainState, Dict]:
        if state.group is not group:
            raise ValueError(f"the state lives on another "
                             f"{type(group).__name__}")
        _build_optimizer(state, ("replicated",), optimizer)
        loss, sq = _local_grads(state, loss_fn, batch)
        with torch.no_grad():
            if rank_form:
                summed = ring_allreduce(state.grads[0], "sum",
                                        impl=collective, group=group)[None]
            else:
                summed = ring_allreduce(state.grads, "sum", impl=collective,
                                        group=group)
            _step_opt(state, 0, [summed[i] for i in range(len(state.ranks))])
        state.step += 1
        return state, {"loss": loss, "grad_norm": torch.sqrt(sq),
                       "step": state.step}

    return step_fn
