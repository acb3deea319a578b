"""Train steps: the counterpart of ``ray_tpu/parallel/train_step.py``.

The reference jits one SPMD step over a mesh and donates the state, so
params and optimizer state are updated in place in device memory. Here
the step runs eagerly on one device and the update is in place too:
``torch.optim.AdamW`` writes the params and its moments where they lie,
and the step returns the same ``TrainState``, advanced.

Over a mesh (``mesh=``, a mesh of virtual ranks, ``parallel.mesh``) the
step is the one-device step on the mesh's device over the whole batch,
since GSPMD's partitioning changes no value; ``param_shardings`` and
``batch_shardings`` are the reference's records and move nothing. The
exception is ``weight_update="sharded"`` on a mesh whose only axis above 1
is ``data``: the reference's rewrite (reduce-scatter + 1/n update +
allgather) runs as ``parallel.zero.build_zero_train_step`` over the mesh's
``RingGroup`` of that axis (kernels C2 and C3 on the card). Its state is a
``ZeroTrainState``; the step converts a ``TrainState`` that has taken no
step on its first call and returns the ZeRO state. As in
``parallel.zero``, its ranks sum their gradients where GSPMD averages
them, so ``grad_norm`` is the ranks' sum and the update differs from the
replicated one only through AdamW's eps. ``state_shardings`` gives the
optimizer state's specs as the reference's does.

The step computes what the reference's does: the loss and gradients of
``loss_fn(params, batch)``; with ``grad_accum`` > 1 the batch is split
into that many micro-batches along its first axis, their gradients are
summed in the params' type and then scaled by 1 / grad_accum, and the
loss is the mean of theirs; the global gradient norm (summed in f32);
one optimizer update; metrics ``{loss, grad_norm, step}``.
``build_eval_step`` is the loss alone, without gradients.

The optimizer is the reference's ``optimizer`` argument in torch's form:
a factory ``params -> torch.optim.Optimizer`` given to
``create_train_state`` (as ``parallel.zero`` takes one), AdamW at
``optax.adamw(1e-4)``'s settings when none is given.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ray_tpu_torch._private.device import resolve_device

Params = Dict[str, Any]
# optax.adamw(1e-4), the optimizer ``bench.py`` trains the reference with:
# betas (0.9, 0.999) and eps 1e-8 are torch's defaults too, but optax's
# weight decay is 1e-4 where torch's is 1e-2.
LR, WEIGHT_DECAY = 1e-4, 1e-4
# params -> torch.optim.Optimizer
Factory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]
DEFAULT_OPTIMIZER: Factory = functools.partial(
    torch.optim.AdamW, lr=LR, weight_decay=WEIGHT_DECAY)


@dataclasses.dataclass
class TrainState:
    """The params, the optimizer over their leaves, the step count and
    the factory that built the optimizer."""

    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0
    make_optimizer: Optional[Factory] = None


def _leaves(params: Params) -> List[torch.Tensor]:
    out = []
    for name in sorted(params):
        value = params[name]
        if isinstance(value, dict):
            out.extend(value[k] for k in sorted(value))
        else:
            out.append(value)
    return out


def create_train_state(params: Params, optimizer: Optional[Factory] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """Params (a tree of tensors) on ``device`` (default: the card), each
    a leaf that requires grad, and ``optimizer(leaves)`` over them
    (default: ``torch.optim.AdamW`` with optax.adamw(1e-4)'s settings;
    with bf16 params its moments are bf16, as optax keeps them in the
    params' type). Tensors already on ``device`` are used in place, not
    copied."""
    dev = resolve_device(device)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        out = t.detach().to(dev).requires_grad_(True)
        if hasattr(t, "sharding"):          # from parallel.shard_params
            out.sharding = t.sharding
        return out

    tree: Params = {
        name: ({k: leaf(t) for k, t in value.items()}
               if isinstance(value, dict) else leaf(value))
        for name, value in params.items()}
    make = DEFAULT_OPTIMIZER if optimizer is None else optimizer
    return TrainState(params=tree, optimizer=make(_leaves(tree)),
                      make_optimizer=make)


def _micro_batches(batch: Dict[str, torch.Tensor],
                   n: int) -> List[Dict[str, torch.Tensor]]:
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into "
                         f"grad_accum={n} micro-batches")
    chunks = {k: v.chunk(n, dim=0) for k, v in batch.items()}
    return [{k: v[i] for k, v in chunks.items()} for i in range(n)]


def _mesh_device(mesh, device):
    """The device a step over ``mesh`` runs on: the mesh's (its virtual
    ranks lie on one device), which ``device``, where given, must be."""
    if mesh.group is not None:
        raise NotImplementedError(
            "a train step over a collective group's mesh (one rank per "
            "process) comes with the mesh across processes; over a "
            "cuda group use parallel.build_zero_train_step(..., group)")
    dev = mesh.device
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"device {device} is not the mesh's {dev}")
    return dev


def _zero_axis_only(mesh) -> bool:
    """Whether ``data`` is the mesh's only axis above 1 (and is above 1):
    the mesh on which the sharded update is the ZeRO rewrite."""
    from ray_tpu_torch.parallel.mesh import mesh_axis_size

    others = [a for a in mesh.axis_names if a != "data" and mesh.shape[a] > 1]
    return not others and mesh_axis_size(mesh, "data") > 1


def _zero_step(loss_fn, optimizer: Optional[Factory], group):
    """The sharded update over ``group``: ``build_zero_train_step`` with
    the state's optimizer factory, converting a fresh ``TrainState``."""
    from ray_tpu_torch.parallel.zero import (
        ZeroTrainState, build_zero_train_step, create_zero_state)

    steps: Dict[int, Callable] = {}

    def step_fn(state, batch):
        if isinstance(state, TrainState):
            if state.step:
                raise ValueError(
                    "the sharded update keeps its own optimizer state: "
                    "give it a TrainState that has taken no step, or a "
                    "ZeroTrainState over the mesh's data RingGroup")
            state = create_zero_state(state.params, state.make_optimizer,
                                      group)
        if not isinstance(state, ZeroTrainState):
            raise TypeError(f"expected a TrainState or ZeroTrainState, got "
                            f"{type(state).__name__}")
        factory = state.make_optimizer
        if optimizer is not None and optimizer is not factory:
            raise ValueError("the step was given another optimizer factory "
                             "than create_train_state")
        step = steps.get(id(factory))
        if step is None:
            step = steps[id(factory)] = build_zero_train_step(
                loss_fn, factory, group)
        return step(state, batch)

    return step_fn


def build_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: Optional[Factory] = None,
    *,
    grad_accum: int = 1,
    weight_update: str = "replicated",
    mesh: Any = None,
    param_shardings: Any = None,
    batch_shardings: Any = None,
    params_shape: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Returns ``step(state, batch) -> (state, metrics)``: one update by
    the state's optimizer. ``optimizer``, where given, must be the factory
    the state was created with (the reference passes its optimizer to
    both). ``batch`` holds tensors or arrays; they are moved to
    ``device`` (default: the card, or the mesh's device). ``metrics``
    holds the loss and the global grad norm as f32 scalar tensors on the
    device (reading them waits for the step) and the new step count.
    ``mesh``, ``param_shardings``, ``batch_shardings``, ``params_shape``
    and ``weight_update="sharded"`` are the reference's; see the module
    docstring for what they do on a mesh of virtual ranks."""
    if weight_update not in ("replicated", "sharded"):
        raise ValueError(
            f"weight_update must be 'replicated'|'sharded', got "
            f"{weight_update!r}")
    if weight_update == "sharded":
        if params_shape is None:
            raise ValueError(
                "weight_update='sharded' needs params_shape "
                "(the param tree's shapes)")
        if mesh is None:
            raise ValueError(
                "weight_update='sharded' shards the update over a mesh's "
                "'data' axis: give mesh=")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device) if mesh is None else \
        _mesh_device(mesh, device)
    if weight_update == "sharded" and _zero_axis_only(mesh):
        if grad_accum != 1:
            raise ValueError("the sharded update over a data mesh takes "
                             "grad_accum=1")
        return _zero_step(loss_fn, optimizer, mesh.ring_group("data"))

    def step_fn(state: TrainState, batch: Dict[str, Any]
                ) -> Tuple[TrainState, Dict]:
        if optimizer is not None and optimizer is not state.make_optimizer:
            raise ValueError("the step was given another optimizer factory "
                             "than create_train_state")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        leaves = _leaves(state.params)
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in _micro_batches(batch, grad_accum):
            micro = loss_fn(state.params, mb)
            micro.backward()
            loss = loss + micro.detach().float()
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            loss = loss * inv
            for t in leaves:
                if t.grad is not None:
                    t.grad.mul_(inv)
        grads = [t.grad for t in leaves if t.grad is not None]
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "step": state.step}

    return step_fn


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def state_shardings(param_shardings, optimizer: Optional[Factory],
                    params_shape, mesh,
                    weight_update: str = "replicated") -> Dict[str, Any]:
    """Shardings of the whole train state, as the reference's: the params'
    own; each optimizer-state entry that mirrors its param (AdamW's
    ``exp_avg``, ``exp_avg_sq``) takes the param's sharding, with
    ``data`` folded into dim 0 under ``weight_update="sharded"`` where
    dim 0 is unsharded and divides the axis (the reference's
    ``zero_moment_shardings``); every other entry (the step counters) is
    replicated. Returns ``{"params", "opt_state": {entry: tree},
    "step"}``. The optimizer's entries are found by one step of
    ``optimizer`` (default AdamW) on meta tensors of ``params_shape``
    (a tree of shapes or tensors)."""
    from ray_tpu_torch.parallel.mesh import mesh_axis_size
    from ray_tpu_torch.parallel.sharding import (
        NamedSharding, PartitionSpec, _tree_map, replicated)

    repl = replicated(mesh)
    shapes = _tree_map(_shape, params_shape)
    metas = _tree_map(lambda sh: torch.zeros(sh, device="meta",
                                             requires_grad=True), shapes)
    meta_leaves = _leaves(metas)
    opt = (optimizer or DEFAULT_OPTIMIZER)(meta_leaves)
    for t in meta_leaves:
        t.grad = torch.zeros_like(t)
    opt.step()
    mirrored = sorted({name for t in meta_leaves
                       for name, v in opt.state[t].items()
                       if torch.is_tensor(v) and v.shape == t.shape
                       and v.dim() > 0})
    n_data = mesh_axis_size(mesh, "data")

    def moment(sh: NamedSharding, shape) -> NamedSharding:
        if weight_update != "sharded" or not shape \
                or "data" not in mesh.axis_names:
            return sh
        entries = tuple(sh.spec) or (None,)
        if shape[0] % n_data or entries[0] is not None:
            return sh
        return NamedSharding(mesh, PartitionSpec("data", *entries[1:]))

    opt_state = {name: _tree_map(moment, param_shardings, shapes)
                 for name in mirrored}
    opt_state["step"] = repl
    return {"params": param_shardings, "opt_state": opt_state, "step": repl}


def build_eval_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    device: Optional[Union[str, torch.device]] = None,
    *,
    mesh: Any = None,
    batch_shardings: Any = None,
) -> Callable[[Params, Dict[str, Any]], torch.Tensor]:
    """Returns ``eval_step(params, batch) -> loss``: ``loss_fn`` on the
    batch moved to ``device`` (default: the card, or ``mesh``'s device),
    without gradients; the counterpart of the reference's
    ``build_eval_step(loss_fn, mesh, batch_shardings)``."""
    dev = resolve_device(device) if mesh is None else \
        _mesh_device(mesh, device)

    def eval_fn(params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_fn
