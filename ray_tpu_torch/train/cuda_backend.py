"""CudaBackend — the port's Train backend, the counterpart of
``ray_tpu/train/jax_backend.py`` (``JaxBackend``, ``JaxConfig``,
``run_pod_training``, ``pod_train_loop``).

The reference's backend calls ``jax.distributed.initialize`` on every
worker so that one SPMD mesh spans the W processes, and its
``run_pod_training`` shards the batch and the ZeRO update over them. The
port's data ranks are ``parallel.zero``'s: n virtual ranks on one device
(a ``RingGroup``), or one rank per process (a ``CudaGroup``, the ring
kernels' rank forms across processes that share the card). So:

- ``on_start`` at world size 1 forms nothing. At W > 1 it forms a gloo
  process group through rank 0's address (every worker must agree on its
  size, as the reference checks device counts) and a ``cuda`` collective
  group over the W workers (``util.collective``; on the card each worker
  a rank of the ring kernels' rank forms, under ``CudaConfig(device=
  "cpu")`` the plain rings over gloo). A worker without the card that
  its config asks for raises there, naming it. ``on_shutdown`` destroys
  the group (its IPC mappings and workspace) and the process group.
- ``run_pod_training`` at W = 1: ``mesh_axes={"data": n}`` means n
  virtual ranks, and ``"data": -1`` raises (no device count to absorb).
  At W > 1 each worker is one of W data ranks over the gang's group:
  ``mesh_axes`` of None, ``{"data": -1}`` or ``{"data": W}``; any other
  ``data`` raises, naming both numbers, as the reference's ``make_mesh``
  refuses a mesh its devices do not fill. Every worker makes the same
  global batch from ``seed`` and takes its own rows of it.
- Routes: ``weight_update="replicated"`` on one rank is
  ``build_train_step`` (B1–B3 on the card); on n ranks
  ``build_replicated_train_step`` (B1–B3, C4); ``"sharded"`` is
  ``build_zero_train_step`` (B1–B3, C2 + C3); ``overlap=True`` its
  split-phase form (B1–B3, C1 per hop); across processes the same steps
  run the kernels' rank forms. ``fsdp`` and ``tensor`` axes raise (the
  mesh-parallel slice).

The ranks sum their gradients (the ZeRO step's contract); the reference's
GSPMD routes average them. AdamW divides each element by its own running
magnitude, so the two differ only through eps (1e-8), below the losses'
f32 rounding at the tests' sizes.
"""

from __future__ import annotations

import functools
import time
import uuid
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
# leaves a key out, and the name of the gang's collective group (set on
# each worker by CudaBackend.on_start).
_worker_defaults: Dict[str, Any] = {}
# How long a gang rank's ring call waits for its peers before the group
# fails: a rank that finishes its backward first waits there for the
# slowest (the ranks time-slice one card).
GANG_WAIT_S = 120.0


def _setup_cuda_worker(defaults: Dict[str, Any]) -> int:
    """Record the backend's defaults; returns the world size the worker
    sees (1 outside a process group)."""
    global _worker_defaults
    _worker_defaults = dict(defaults)
    return _process_group_size()


def _join_gang(world_size: int, rank: int, name: str,
               device: Optional[str]) -> bool:
    """Make this worker rank ``rank`` of the gang's ``cuda`` group."""
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(world_size, rank, backend="cuda",
                              group_name=name, device=device,
                              wait_timeout_s=GANG_WAIT_S)
    return True


def _leave_gang(name: str) -> None:
    from ray_tpu_torch.util import collective as col

    col.destroy_collective_group(name)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class CudaBackend(Backend):
    def on_start(self, worker_group, backend_config: CudaConfig) -> None:
        import ray_tpu_torch

        world_size = worker_group.num_workers
        name = None
        if world_size > 1:
            form_process_group(worker_group, "gloo", timeout_s=120.0)
            name = f"cuda_backend:{uuid.uuid4().hex[:12]}"
            ray_tpu_torch.get([
                w.execute.remote(_join_gang, world_size, rank, name,
                                 backend_config.device)
                for rank, w in enumerate(worker_group.workers)],
                timeout=600)
        self._gang = name
        defaults = {"device": backend_config.device,
                    "mesh_axes": backend_config.mesh_axes,
                    "weight_update": backend_config.weight_update,
                    "overlap": backend_config.overlap,
                    "group_name": name}
        sizes = worker_group.execute(_setup_cuda_worker, defaults)
        # Every worker must see the whole gang: a mismatch means a partial
        # group (some worker failed to join).
        if set(sizes) != {world_size}:
            raise RuntimeError(
                f"inconsistent world size across workers: {sizes} "
                f"(want {world_size})")

    def on_shutdown(self, worker_group, backend_config: CudaConfig) -> None:
        name = getattr(self, "_gang", None)
        if name is not None:
            try:
                worker_group.execute(_leave_gang, name)
            except Exception:
                pass
            self._gang = None
        try:
            worker_group.execute(_shutdown_torch_process_group)
        except Exception:
            pass


def _data_ranks(mesh_axes: Optional[dict], world_size: int = 1) -> int:
    """The number of data ranks ``mesh_axes`` asks for: virtual ranks on
    one device at world size 1, else the W processes of the gang."""
    axes = dict(mesh_axes) if mesh_axes else {
        "data": -1 if world_size > 1 else 1}
    other = {ax: size for ax, size in axes.items()
             if ax != "data" and size != 1}
    if other:
        raise NotImplementedError(
            f"mesh_axes {axes}: the port shards only over 'data' (virtual "
            f"ranks on one device); the non-trivial axes {other} come with "
            "the mesh-parallel slice (fsdp, tensor, sequence and expert "
            "parallelism)")
    n = int(axes.get("data", 1))
    if world_size > 1:
        if n not in (-1, world_size):
            raise ValueError(
                f"mesh_axes {axes}: 'data': {n} does not match the "
                f"{world_size} workers of the gang (each worker is one data "
                f"rank); give 'data': {world_size} or -1")
        return world_size
    if n == -1:
        raise ValueError(
            f"mesh_axes {axes}: 'data': -1 absorbs the device count in the "
            "reference, but the port's data ranks are virtual ranks on one "
            "device, so there is no device count to absorb; give the number "
            "of ranks, e.g. {'data': 4}")
    if n < 1:
        raise ValueError(f"mesh_axes {axes}: 'data' must be >= 1")
    return n


def gang_group(device: Optional[Union[str, torch.device]] = None):
    """The gang's ``cuda`` collective group in this worker (formed by
    ``CudaBackend.on_start`` at W > 1), for a loop that builds its own
    ``parallel.zero`` step over the W ranks; ``device`` (default: the
    card) must be the group's."""
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.util.collective.collective import _group_mgr

    name = _worker_defaults.get("group_name")
    if name is None:
        raise RuntimeError(
            "no gang here: the gang's collective group exists in the "
            "workers of a CudaTrainer of several workers")
    group = _group_mgr.get_group(name)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group.device != dev:
        raise ValueError(f"the gang's group runs on {group.device}, the "
                         f"loop on {dev}")
    return group


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
                     device: Optional[Union[str, torch.device]] = None,
                     on_finish=None) -> dict:
    """Run `steps` Llama train steps on ``device`` (default: the card);
    returns throughput metrics, with the reference's keys.

    In a gang of W > 1 workers (``CudaTrainer``) this worker is one of W
    data ranks over the gang's group (see the module docstring).
    ``tokens_per_sec`` is measured over the steps after the warmup step
    (step 0: the first launches and the optimizer's build), which is
    excluded, and counts the global batch. ``n_devices`` is 1: the ranks
    are virtual ranks on the one device, or processes that share it, so
    ``tokens_per_sec_per_chip`` is the card's. ``report``, where given,
    gets ``{"loss", "grad_norm", "step"}`` after each timed step;
    ``on_finish``, where
    given, gets the final train state before the summary returns.

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
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if model_config is None:
        model_config = LlamaConfig(
            vocab_size=512, dim=128, n_layers=4, n_heads=8, n_kv_heads=4,
            hidden_dim=256, max_seq_len=128)
    world = _process_group_size()
    n = _data_ranks(mesh_axes, world)
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
        group = gang_group(dev) if world > 1 else RingGroup(n, dev)
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
                            "grad_norm": float(metrics["grad_norm"]),
                            "step": int(metrics["step"])})
            step_rows.append(sp.finish())
        else:
            state, metrics = step(state, batch)
            if report is not None:
                report({"loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "step": int(metrics["step"])})
    fence()
    elapsed = time.perf_counter() - t0
    loss_value = float(metrics["loss"])
    if on_finish is not None:
        on_finish(state)
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
