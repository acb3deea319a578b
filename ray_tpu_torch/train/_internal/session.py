"""Worker-side training session: the port's copy of
``ray_tpu/train/_internal/session.py``.

Reference: `train/_internal/session.py:109` (`_TrainSession`) — the user's
``train_loop_per_worker`` runs in a dedicated thread; ``report(metrics,
checkpoint)`` passes results through a bounded queue (`session.py:202`) back
to the driver poll loop; checkpoints persist to experiment storage before the
metrics that reference them are released.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: Optional["_TrainSession"] = None


FINISHED = "__finished__"
ERRORED = "__errored__"
REPORT = "__report__"


@dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    storage_dir: str

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_checkpoint(self) -> Optional[Checkpoint]:
        s = get_session()
        return s.latest_checkpoint if s else None

    def get_trial_dir(self) -> str:
        return self.storage_dir


class _TrainSession:
    def __init__(self, train_fn: Callable, config: Dict[str, Any],
                 context: TrainContext,
                 latest_checkpoint: Optional[Checkpoint]):
        self.context = context
        self.latest_checkpoint = latest_checkpoint
        self._result_queue: "queue.Queue" = queue.Queue(maxsize=8)
        self._train_fn = train_fn
        self._config = dict(config or {})
        self._thread: Optional[threading.Thread] = None
        self._report_counter = 0
        self._last_report_ts: Optional[float] = None
        self._telemetry_steps = 0

    def start(self):
        def _run():
            global _session
            _session = self
            try:
                if self._takes_config():
                    self._train_fn(self._config)
                else:
                    self._train_fn()
                outcome = (FINISHED, None, None)
            except BaseException as e:  # noqa: BLE001
                outcome = (ERRORED, f"{type(e).__name__}: {e}\n"
                           f"{traceback.format_exc()}", None)
            self._report_done()
            self._result_queue.put(outcome)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="train-loop")
        self._thread.start()

    def _takes_config(self) -> bool:
        import inspect

        try:
            sig = inspect.signature(self._train_fn)
            return len(sig.parameters) >= 1
        except (TypeError, ValueError):
            return False

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self._record_telemetry(metrics)
        ckpt_path = None
        if checkpoint is not None:
            # Name by a session-side monotonic counter, never user metrics:
            # duplicate names would alias directories and break driver-side
            # top-k retention (reference names checkpoints driver-side with
            # a monotonic index for the same reason).
            from ray_tpu_torch.util.tracing import span

            t0 = time.perf_counter()
            with span("train.checkpoint_persist",
                      attrs={"rank": self.context.world_rank}):
                persisted = checkpoint.persist(
                    self.context.storage_dir,
                    name=f"checkpoint_{self._report_counter:06d}"
                         f"_rank{self.context.world_rank}")
            try:
                from ray_tpu_torch.observability.goodput import (
                    record_checkpoint)

                record_checkpoint(time.perf_counter() - t0)
            except Exception:
                pass  # telemetry must never fail a training step
            self._report_counter += 1
            self.latest_checkpoint = persisted
            ckpt_path = persisted.path
        # Blocks when the driver falls behind (backpressure, reference
        # bounded-queue behavior).
        self._result_queue.put((REPORT, metrics, ckpt_path))

    def _record_telemetry(self, metrics: Dict[str, Any]) -> None:
        """One training step per report(): step duration is the wall
        time since the previous report, loss/throughput are lifted from
        the user's metrics dict when recognizably named."""
        try:
            from ray_tpu_torch.observability.train import (
                record_report_step, train_metrics)

            tm = train_metrics()
            now = time.monotonic()
            tm.reports.inc()
            if self._last_report_ts is not None:
                step_s = now - self._last_report_ts
                tm.step_seconds.observe(step_s)
            else:
                step_s = None
            self._last_report_ts = now
            self._telemetry_steps += 1
            record_report_step(self.context.world_rank,
                               self._telemetry_steps, step_s)
            if isinstance(metrics, dict):
                for key in ("loss", "total_loss", "train_loss"):
                    if isinstance(metrics.get(key), (int, float)):
                        tm.loss.set(float(metrics[key]))
                        break
                for key in ("num_samples", "samples", "batch_size"):
                    n = metrics.get(key)
                    if isinstance(n, (int, float)) and step_s:
                        tm.samples_per_sec.set(float(n) / step_s)
                        break
        except Exception:
            pass  # telemetry must never fail a training step

    def _report_done(self) -> None:
        """Mark the loop's report-driven step rows done: a finished loop
        is not a stall. (The reference's session never does, so its stall
        watchdog flags every finished report-driven loop after
        ``train_stall_min_timeout_s``.)"""
        if self._telemetry_steps < 2:
            return                      # no row was published
        try:
            from ray_tpu_torch.observability.goodput import (
                goodput_enabled, publish_train_done)

            if goodput_enabled():
                publish_train_done(f"rank{int(self.context.world_rank)}")
        except Exception:
            pass  # telemetry must never fail a training step

    def next_result(self, timeout: Optional[float] = None):
        try:
            return self._result_queue.get(timeout=timeout)
        except queue.Empty:
            return None


def get_session() -> Optional[_TrainSession]:
    return _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """`ray_tpu_torch.train.report` — from inside train_loop_per_worker."""
    s = get_session()
    if s is None:
        raise RuntimeError(
            "train.report() called outside a training session")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = get_session()
    if s is None:
        raise RuntimeError("no active training session")
    return s.context


def get_dataset_shard(name: str = "train"):
    """The reference's split of ``datasets=`` for this worker (a
    ``streaming_split`` iterator). The port has no Data library yet:
    this raises, naming the slice that brings it."""
    raise NotImplementedError(
        f"train.get_dataset_shard({name!r}): ray_tpu/data (streaming_split "
        "and data/iterator.py) is not ported yet; it comes with the Data "
        "slice")
