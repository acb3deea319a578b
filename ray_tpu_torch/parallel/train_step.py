"""One-device train step: the counterpart of
``ray_tpu/parallel/train_step.py`` without meshes.

The reference jits one SPMD step over a mesh and donates the state, so
params and optimizer state are updated in place in device memory. Here
the step runs eagerly on one device and the update is in place too:
``torch.optim.AdamW`` writes the params and its moments where they lie,
and the step returns the same ``TrainState``, advanced. Meshes and the GSPMD
sharded update (``weight_update="sharded"``) raise
``NotImplementedError``; data parallelism with a ZeRO-sharded update is
``parallel.zero.build_zero_train_step``.

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
        return t.detach().to(dev).requires_grad_(True)

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


def build_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: Optional[Factory] = None,
    *,
    grad_accum: int = 1,
    weight_update: str = "replicated",
    mesh: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Returns ``step(state, batch) -> (state, metrics)``: one update by
    the state's optimizer. ``optimizer``, where given, must be the factory
    the state was created with (the reference passes its optimizer to
    both). ``batch`` holds tensors or arrays; they are moved to
    ``device`` (default: the card). ``metrics`` holds the loss and the
    global grad norm as f32 scalar tensors on the device (reading them
    waits for the step) and the new step count."""
    if weight_update not in ("replicated", "sharded"):
        raise ValueError(
            f"weight_update must be 'replicated'|'sharded', got "
            f"{weight_update!r}")
    if weight_update == "sharded" or mesh is not None:
        raise NotImplementedError(
            "meshes and the GSPMD sharded weight update are not ported "
            "yet; they come with the mesh-parallel slice. For data "
            "parallelism with a sharded (ZeRO) update use "
            "ray_tpu_torch.parallel.build_zero_train_step over a RingGroup")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)

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


def build_eval_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[Params, Dict[str, Any]], torch.Tensor]:
    """Returns ``eval_step(params, batch) -> loss``: ``loss_fn`` on the
    batch moved to ``device`` (default: the card), without gradients; the
    counterpart of the reference's ``build_eval_step``."""
    dev = resolve_device(device)

    def eval_fn(params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_fn
