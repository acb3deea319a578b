"""CudaBackend — the port's Train backend, the counterpart of
``ray_tpu/train/jax_backend.py`` (``JaxBackend``, ``JaxConfig``,
``run_pod_training``, ``pod_train_loop``).

The reference's backend calls ``jax.distributed.initialize`` on every
worker so that one SPMD mesh spans the pod, then runs a pjit'd Llama step
over it. The port's data parallelism runs ``n`` virtual ranks on the
worker's one device (``parallel.zero``: a ``RingGroup`` whose ring
collectives are the hand-written kernels C1–C4 on the card), so:

- ``on_start`` at world size 1 forms nothing. CPU workers at a larger
  world size form a gloo process group through rank 0's address and check
  that every worker agrees on its size (the reference checks device
  counts). GPU workers at a larger world size raise: one card cannot hold
  two ranks of a process group, and the ring kernels across processes are
  the cross-process collective slice's work (ROADMAP A3).
- ``run_pod_training``'s ``mesh_axes={"data": n}`` means n virtual ranks.
  Its routes: ``weight_update="replicated"`` at n = 1 is
  ``build_train_step`` (B1–B3 on the card); at n > 1
  ``build_replicated_train_step`` (B1–B3, C4); ``"sharded"`` is
  ``build_zero_train_step`` (B1–B3, C2 + C3); ``overlap=True`` its
  split-phase form (B1–B3, C1 per hop). ``fsdp`` and ``tensor`` axes
  raise (the mesh-parallel slice, ROADMAP A7).

The ranks sum their gradients (the ZeRO step's contract); the reference's
GSPMD routes average them. AdamW divides each element by its own running
magnitude, so the two differ only through eps (1e-8), below the losses'
f32 rounding at the tests' sizes.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.torch_backend import (
    _shutdown_torch_process_group, form_process_group,
)


@dataclass
class CudaConfig(BackendConfig):
    # The workers' device: None is the card each worker's GPU lease names;
    # "cpu" for the tests (the kernels' plain versions run there).
    device: Optional[str] = None
    # Defaults for workers that call `pod_train_loop` without these keys
    # in their config: {"data": n} is n virtual ranks on the device.
    mesh_axes: Optional[dict] = None
    # "replicated" | "sharded": the ZeRO-sharded update (parallel.zero).
    weight_update: str = "replicated"
    # The split-phase overlap of the gradient reduce-scatter and the
    # param allgather with the optimizer math; implies "sharded".
    overlap: bool = False

    @property
    def backend_cls(self):
        return CudaBackend


# What the worker's CudaConfig gives `pod_train_loop` where its config
# leaves a key out (set on each worker by CudaBackend.on_start).
_worker_defaults: Dict[str, Any] = {}


def _on_card(device: Optional[Union[str, torch.device]]) -> bool:
    return device is None or torch.device(device).type == "cuda"


def _setup_cuda_worker(defaults: Dict[str, Any]) -> int:
    """Record the backend's defaults; returns the world size the worker
    sees (1 outside a process group)."""
    global _worker_defaults
    _worker_defaults = dict(defaults)
    return _process_group_size()


class CudaBackend(Backend):
    def on_start(self, worker_group, backend_config: CudaConfig) -> None:
        world_size = worker_group.num_workers
        if world_size > 1 and _on_card(backend_config.device):
            raise NotImplementedError(
                f"CudaBackend: {world_size} GPU workers would form one "
                "process group of ranks on the card, which one card cannot "
                "hold, and the port's ring kernels across processes come "
                "with the cross-process collective slice. Run "
                "one GPU worker with mesh_axes={'data': n} (n virtual ranks "
                "on its card), or CPU workers with CudaConfig(device='cpu')")
        if world_size > 1:
            form_process_group(worker_group, "gloo", timeout_s=120.0)
        defaults = {"device": backend_config.device,
                    "mesh_axes": backend_config.mesh_axes,
                    "weight_update": backend_config.weight_update,
                    "overlap": backend_config.overlap}
        sizes = worker_group.execute(_setup_cuda_worker, defaults)
        # Every worker must see the whole gang: a mismatch means a partial
        # group (some worker failed to join).
        if set(sizes) != {world_size}:
            raise RuntimeError(
                f"inconsistent world size across workers: {sizes} "
                f"(want {world_size})")

    def on_shutdown(self, worker_group, backend_config: CudaConfig) -> None:
        try:
            worker_group.execute(_shutdown_torch_process_group)
        except Exception:
            pass


def _data_ranks(mesh_axes: Optional[dict]) -> int:
    """The number of virtual data ranks ``mesh_axes`` asks for."""
    axes = dict(mesh_axes) if mesh_axes else {"data": 1}
    other = {ax: size for ax, size in axes.items()
             if ax != "data" and size != 1}
    if other:
        raise NotImplementedError(
            f"mesh_axes {axes}: the port shards only over 'data' (virtual "
            f"ranks on one device); the non-trivial axes {other} come with "
            "the mesh-parallel slice (fsdp, tensor, sequence and expert "
            "parallelism)")
    n = int(axes.get("data", 1))
    if n == -1:
        raise ValueError(
            f"mesh_axes {axes}: 'data': -1 absorbs the device count in the "
            "reference, but the port's data ranks are virtual ranks on one "
            "device, so there is no device count to absorb; give the number "
            "of ranks, e.g. {'data': 4}")
    if n < 1:
        raise ValueError(f"mesh_axes {axes}: 'data' must be >= 1")
    return n


def _process_group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# The training loop: from "the worker holds its device" to tokens/sec.
# `CudaTrainer(pod_train_loop, ...)` uses it as a train_loop_per_worker;
# `run_pod_training` can be called directly too, so both exercise the
# identical code path.
# ---------------------------------------------------------------------------

def run_pod_training(model_config=None, mesh_axes=None, steps: int = 4,
                     batch_size: Optional[int] = None, seq_len: int = 33,
                     weight_update: str = "replicated",
                     learning_rate: float = 1e-3, seed: int = 0,
                     overlap: bool = False, n_chunks: int = 4,
                     collective: str = "auto", report=None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> dict:
    """Run `steps` Llama train steps on ``device`` (default: the card);
    returns throughput metrics, with the reference's keys.

    ``tokens_per_sec`` is measured over the steps after the warmup step
    (step 0: the first launches and the optimizer's build), which is
    excluded. ``n_devices`` is 1: the ``mesh_axes`` ranks are virtual
    ranks on the one device, so ``tokens_per_sec_per_chip`` is the
    card's. ``report``, where given, gets ``{"loss", "step"}`` after
    each timed step.

    When ``train_goodput_instrumentation`` is on (default), the loop
    runs under the per-step phase ledger (`observability.goodput`):
    each step's compute phase closes on ``torch.cuda.synchronize()``
    (on the CPU the step has finished when it returns), the report is
    its ``weight_publish`` phase, the warmup step is booked as
    ``recompiling`` lost time, and each step publishes a heartbeat row
    into the GCS step matrix. The returned dict then carries
    ``goodput`` (the worker ledger snapshot), ``phase_seconds``
    (per-phase sums over the timed steps) and ``step_walls``.
    """
    from ray_tpu_torch._private.config import GlobalConfig
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.observability.goodput import (
        GoodputLedger, StepPhases, goodput_metrics, publish_train_done,
        set_active_ledger,
    )
    from ray_tpu_torch.parallel import (
        build_replicated_train_step, build_train_step,
        build_zero_train_step, create_train_state, create_zero_state,
    )
    from ray_tpu_torch.parallel.train_step import WEIGHT_DECAY
    from ray_tpu_torch.util.collective import RingGroup

    dev = resolve_device(device)
    if model_config is None:
        model_config = LlamaConfig(
            vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
            hidden_dim=256, max_seq_len=128)
    n = _data_ranks(mesh_axes)
    if overlap:
        weight_update = "sharded"
    if weight_update not in ("replicated", "sharded"):
        raise ValueError(f"weight_update must be 'replicated'|'sharded', "
                         f"got {weight_update!r}")

    def loss(p, b):
        return loss_fn(p, b, model_config)

    # optax.adamw(learning_rate)'s settings: torch's betas and eps, and
    # optax's weight decay.
    optimizer = functools.partial(torch.optim.AdamW, lr=learning_rate,
                                  weight_decay=WEIGHT_DECAY)
    params = init_params(model_config, seed, device=dev)
    if weight_update == "replicated" and n == 1:
        state = create_train_state(params, optimizer, device=dev)
        step = build_train_step(loss, optimizer, device=dev)
    else:
        group = RingGroup(n, dev)
        state = create_zero_state(params, optimizer, group)
        if weight_update == "replicated":
            step = build_replicated_train_step(loss, optimizer, group,
                                               collective=collective)
        else:
            step = build_zero_train_step(loss, optimizer, group,
                                         collective=collective,
                                         overlap=overlap, n_chunks=n_chunks)
    del params                       # the state holds its own copy or views

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # The batch must divide evenly over the data ranks.
    if batch_size is None:
        batch_size = max(8, n)
    if batch_size % n:
        batch_size = ((batch_size + n - 1) // n) * n
    instrument = bool(GlobalConfig.train_goodput_instrumentation)
    worker_label = f"train-{_process_index()}"
    ledger = GoodputLedger(worker=worker_label) if instrument else None
    if ledger is not None:
        set_active_ledger(ledger)

    rng = np.random.RandomState(seed)
    host_tokens = rng.randint(0, model_config.vocab_size,
                              (batch_size, seq_len)).astype("int32")
    t_h2d = time.perf_counter()
    batch = {"tokens": torch.from_numpy(host_tokens).to(dev, torch.int64)}
    if ledger is not None:
        # One-off input transfer: an h2d histogram sample + stalled
        # ledger time (a real input pipeline pays this per step).
        h2d_s = time.perf_counter() - t_h2d
        goodput_metrics().step_phase_seconds.observe(
            h2d_s, {"phase": "h2d"})
        ledger.book_phases({"h2d": h2d_s})
    tokens_per_step = batch_size * (seq_len - 1)  # next-token targets

    t_warm = time.perf_counter()
    state, metrics = step(state, batch)  # first launches + warmup
    fence()
    if ledger is not None:
        # The warmup step is wall time the worker spent not training,
        # booked as the reference books its compile step.
        ledger.lose("recompiling", time.perf_counter() - t_warm)

    step_rows = []
    t0 = time.perf_counter()
    for i in range(steps):
        if ledger is not None:
            sp = StepPhases(step=i, worker=worker_label, ledger=ledger)
            with sp.phase("compute"):
                state, metrics = step(state, batch)
                # Phase attribution needs the step's device work fenced
                # inside its timed section (launching alone is cheap).
                fence()
            if report is not None:
                with sp.phase("weight_publish"):
                    report({"loss": float(metrics["loss"]),
                            "step": int(metrics["step"])})
            step_rows.append(sp.finish())
        else:
            state, metrics = step(state, batch)
            if report is not None:
                report({"loss": float(metrics["loss"]),
                        "step": int(metrics["step"])})
    fence()
    elapsed = time.perf_counter() - t0
    loss_value = float(metrics["loss"])
    tokens_per_sec = tokens_per_step * steps / max(elapsed, 1e-9)
    extra = {}
    if ledger is not None:
        phase_seconds: dict = {}
        for row in step_rows:
            for phase, dur in row["phases"].items():
                phase_seconds[phase] = phase_seconds.get(phase, 0.0) + dur
        extra = {"goodput": ledger.snapshot(),
                 "phase_seconds": phase_seconds,
                 "step_walls": [row["wall_s"] for row in step_rows]}
        set_active_ledger(None)
        publish_train_done(worker_label)
    n_devices = 1
    return {
        **extra,
        "n_devices": n_devices,
        "mesh": {"data": n},
        "weight_update": weight_update,
        "overlap": overlap,
        "steps": steps,
        "batch_size": batch_size,
        "seq_len": seq_len,
        "loss": loss_value,
        "train_seconds": elapsed,
        "tokens_per_sec": tokens_per_sec,
        "tokens_per_sec_per_chip": tokens_per_sec / n_devices,
    }


def pod_train_loop(config: Optional[dict] = None) -> None:
    """`train_loop_per_worker` for `CudaTrainer`: Llama training over the
    worker's data ranks, reporting the summary once.

    Config keys (all optional): ``mesh_axes``, ``weight_update``,
    ``overlap``, ``steps``, ``batch_size``, ``seq_len``,
    ``learning_rate``, ``seed``, ``n_chunks``, ``collective``,
    ``device`` and ``model_config`` (a LlamaConfig). ``device``,
    ``mesh_axes``, ``weight_update`` and ``overlap`` default to the
    backend's `CudaConfig` when driven through `CudaTrainer`.
    """
    from ray_tpu_torch import train

    config = dict(config or {})
    d = _worker_defaults
    summary = run_pod_training(
        model_config=config.get("model_config"),
        mesh_axes=config.get("mesh_axes", d.get("mesh_axes")),
        steps=int(config.get("steps", 4)),
        batch_size=config.get("batch_size"),
        seq_len=int(config.get("seq_len", 33)),
        weight_update=config.get("weight_update",
                                 d.get("weight_update", "replicated")),
        learning_rate=float(config.get("learning_rate", 1e-3)),
        seed=int(config.get("seed", 0)),
        overlap=bool(config.get("overlap", d.get("overlap", False))),
        n_chunks=int(config.get("n_chunks", 4)),
        collective=config.get("collective", "auto"),
        report=None,
        device=config.get("device", d.get("device")),
    )
    train.report(summary)
