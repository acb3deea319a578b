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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ray_tpu_torch._private.device import resolve_device

Params = Dict[str, Any]
# optax.adamw(1e-4), the optimizer ``bench.py`` trains the reference with:
# betas (0.9, 0.999) and eps 1e-8 are torch's defaults too, but optax's
# weight decay is 1e-4 where torch's is 1e-2.
LR, WEIGHT_DECAY = 1e-4, 1e-4


@dataclasses.dataclass
class TrainState:
    params: Params
    optimizer: torch.optim.Optimizer
    step: int = 0


def _leaves(params: Params) -> List[torch.Tensor]:
    out = []
    for name in sorted(params):
        value = params[name]
        if isinstance(value, dict):
            out.extend(value[k] for k in sorted(value))
        else:
            out.append(value)
    return out


def create_train_state(params: Params,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """Params (a tree of tensors) on ``device`` (default: the card), each
    a leaf that requires grad, and ``torch.optim.AdamW`` over them with
    optax.adamw(1e-4)'s settings. With bf16 params its moments are bf16,
    as optax keeps them in the params' type. Tensors already on
    ``device`` are used in place, not copied."""
    dev = resolve_device(device)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(dev).requires_grad_(True)

    tree: Params = {
        name: ({k: leaf(t) for k, t in value.items()}
               if isinstance(value, dict) else leaf(value))
        for name, value in params.items()}
    return TrainState(params=tree, optimizer=torch.optim.AdamW(
        _leaves(tree), lr=LR, weight_decay=WEIGHT_DECAY))


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
    grad_accum: int = 1,
    weight_update: str = "replicated",
    mesh: Any = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Returns ``step(state, batch) -> (state, metrics)``. ``batch``
    holds tensors or arrays; they are moved to ``device`` (default: the
    card). ``metrics`` holds the loss and the global grad norm as f32
    scalar tensors on the device (reading them waits for the step) and
    the new step count."""
    if weight_update not in ("replicated", "sharded"):
        raise ValueError(
            f"weight_update must be 'replicated'|'sharded', got "
            f"{weight_update!r}")
    if weight_update == "sharded" or mesh is not None:
        raise NotImplementedError(
            "meshes and the GSPMD sharded weight update are not ported "
            "(ROADMAP A7); for data parallelism with a sharded (ZeRO) "
            "update use ray_tpu_torch.parallel.build_zero_train_step over "
            "a RingGroup")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)

    def step_fn(state: TrainState, batch: Dict[str, Any]
                ) -> Tuple[TrainState, Dict]:
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
