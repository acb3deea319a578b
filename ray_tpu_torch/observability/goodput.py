"""Training goodput & straggler observability: the port's copy of
``ray_tpu/observability/goodput.py``.

The train-tier questions that matter at pod scale on preemptible
slices (Podracer, arXiv:2104.06272): what fraction of wall time was
productive FLOPs, which worker is slowing the pod, and is a step
stalled or just slow. Three cooperating pieces answer them:

- :class:`StepPhases` — a per-step phase timer threaded through the
  training loop (`train/cuda_backend.py`)
  that decomposes each step into the ``TRAIN_PHASES`` vocabulary
  (data-wait / h2d / compute / exposed-collective / optimizer /
  checkpoint / weight-publish), emits
  ``rtpu_train_step_phase_seconds{phase}`` histograms (with trace
  exemplars) plus a ``train.step`` span, and publishes one
  ``(worker, step, phases, wall)`` row into the GCS step matrix
  (``report_train_steps``).
- :class:`GoodputLedger` — a per-worker wall-clock ledger classifying
  accounted time as productive vs lost-by-cause (stalled / recompiling
  / restarting / checkpointing), exported as the
  ``rtpu_train_goodput_ratio`` gauge and the cumulative
  ``rtpu_train_lost_seconds_total{cause}`` counter — the number
  elastic training is judged by. The warmup step (the port's steps are
  eager: its first launches and the optimizer's build) feeds the
  ``recompiling`` cause, as the reference's compile step does;
  ``note_exposed_collective`` feeds the exposed-collective phase of
  the live step.
- :class:`StragglerDetector` — the cross-worker comparator over the
  GCS step matrix: a worker whose recent mean step time exceeds the
  pod median by ``train_straggler_threshold`` is flagged with the
  *dominant phase* (largest excess over the peer median per phase, so
  an injected data stall names ``data_wait`` even when compute
  dominates absolute time). The GCS turns flags into typed
  ``TRAIN_STRAGGLER`` cluster events; its stall watchdog turns missing
  step heartbeats into ``TRAIN_STALL`` events carrying auto-captured
  thread stacks of the stalled worker.

Everything is gated on the ``train_goodput_instrumentation`` knob, so
the loop runs uninstrumented with it off.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Optional

# Per-step phase vocabulary (display order). The classification below
# maps each phase into the goodput ledger's buckets: an accelerator
# doing optimizer math is productive; one waiting on the input
# pipeline, host->device transfer, or an exposed collective is stalled.
TRAIN_PHASES = ("data_wait", "h2d", "compute", "exposed_collective",
                "optimizer", "checkpoint", "weight_publish")

# Lost-time causes of the goodput ledger; "productive" is the
# complement. "restarting" is booked by elastic restart paths,
# "recompiling" by the warmup step (``record_recompile``).
GOODPUT_CAUSES = ("stalled", "recompiling", "restarting", "checkpointing")

_PHASE_CLASS = {
    "data_wait": "stalled",
    "h2d": "stalled",
    "compute": "productive",
    "exposed_collective": "stalled",
    "optimizer": "productive",
    "checkpoint": "checkpointing",
    "weight_publish": "checkpointing",
}

# Training phases straddle sub-ms (queue pops) to minutes (pod-scale
# checkpoint persists).
_PHASE_BOUNDARIES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5, 5.0, 15.0, 60.0)

_goodput = None
_lock = threading.Lock()

# Process-wide "live" instrumentation targets: one training loop per
# process (train workers are dedicated processes), so the recompile
# hook and the exposed-collective hook can find where to book their
# time without threading handles everywhere.
_active_ledger: Optional["GoodputLedger"] = None
_active_step: Optional["StepPhases"] = None


class GoodputMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        self.step_phase_seconds = Histogram(
            "train_step_phase_seconds", boundaries=_PHASE_BOUNDARIES,
            tag_keys=("phase",),
            description="Wall time of one training-step phase "
                        "(data_wait/h2d/compute/exposed_collective/"
                        "optimizer/checkpoint/weight_publish); per-step "
                        "phase sums match step wall time.")
        self.goodput_ratio = Gauge(
            "train_goodput_ratio",
            description="Productive fraction of this worker's accounted "
                        "training wall time (1.0 = every second was "
                        "compute/optimizer FLOPs).")
        self.lost_seconds = Counter(
            "train_lost_seconds_total", tag_keys=("cause",),
            description="Cumulative non-productive training wall time "
                        "by cause (stalled/recompiling/restarting/"
                        "checkpointing).")


def goodput_metrics() -> GoodputMetrics:
    global _goodput
    with _lock:
        if _goodput is None:
            _goodput = GoodputMetrics()
        return _goodput


def goodput_enabled() -> bool:
    from ray_tpu_torch._private.config import GlobalConfig

    return bool(GlobalConfig.train_goodput_instrumentation)


def classify_phase(phase: str) -> str:
    """Goodput bucket of a step phase: "productive" or a lost cause."""
    return _PHASE_CLASS.get(phase, "stalled")


# ------------------------------------------------------------------ ledger

class GoodputLedger:
    """Per-worker wall-clock classifier: productive vs lost-by-cause.

    Accounted time is whatever callers book (phase timers, compile
    hooks, restart paths) — the ratio is productive/accounted, so an
    uninstrumented gap neither inflates nor deflates it. Every booking
    refreshes the ``rtpu_train_goodput_ratio`` gauge; lost time also
    feeds the cumulative ``rtpu_train_lost_seconds_total{cause}``.
    """

    def __init__(self, worker: str = ""):
        self.worker = str(worker)
        self._t0 = time.perf_counter()
        self.productive_s = 0.0
        self.lost_s: Dict[str, float] = {c: 0.0 for c in GOODPUT_CAUSES}
        self._lk = threading.Lock()

    def note_productive(self, seconds: float) -> None:
        with self._lk:
            self.productive_s += max(float(seconds), 0.0)
        self._export()

    def lose(self, cause: str, seconds: float) -> None:
        if cause not in GOODPUT_CAUSES:
            raise ValueError(f"unknown goodput loss cause {cause!r} "
                             f"(want one of {GOODPUT_CAUSES})")
        seconds = max(float(seconds), 0.0)
        with self._lk:
            self.lost_s[cause] += seconds
        if seconds:
            goodput_metrics().lost_seconds.inc(seconds, {"cause": cause})
        self._export()

    def book_phases(self, durations: Dict[str, float]) -> None:
        """Classify one step's phase durations into the ledger."""
        for phase, dur in durations.items():
            bucket = classify_phase(phase)
            if bucket == "productive":
                self.note_productive(dur)
            else:
                self.lose(bucket, dur)

    def ratio(self) -> float:
        with self._lk:
            lost = sum(self.lost_s.values())
            accounted = self.productive_s + lost
            if accounted <= 0:
                return 1.0
            return self.productive_s / accounted

    def snapshot(self) -> Dict[str, Any]:
        with self._lk:
            lost = dict(self.lost_s)
            productive = self.productive_s
        total_lost = sum(lost.values())
        accounted = productive + total_lost
        return {
            "worker": self.worker,
            "wall_s": time.perf_counter() - self._t0,
            "productive_s": productive,
            "lost_s": lost,
            "accounted_s": accounted,
            "goodput_ratio": (productive / accounted
                              if accounted > 0 else 1.0),
        }

    def _export(self) -> None:
        try:
            goodput_metrics().goodput_ratio.set(self.ratio())
        except Exception:
            pass


def set_active_ledger(ledger: Optional[GoodputLedger]) -> None:
    global _active_ledger
    with _lock:
        _active_ledger = ledger


def active_ledger() -> Optional[GoodputLedger]:
    return _active_ledger


def record_recompile(seconds: float) -> None:
    """Recompile hook: book compile (or warmup) wall time as
    ``recompiling`` against the process's active ledger (no-op when no
    training loop is live — serving-side compiles are not train loss)."""
    led = _active_ledger
    if led is not None:
        led.lose("recompiling", seconds)


def record_checkpoint(seconds: float) -> None:
    """Checkpoint-persist hook (train session): books into the live
    step's ``checkpoint`` phase when one is open, else straight into
    the phase histogram and the active ledger."""
    sp = _active_step
    if sp is not None:
        sp.add("checkpoint", seconds)
        return
    try:
        goodput_metrics().step_phase_seconds.observe(
            max(float(seconds), 0.0), {"phase": "checkpoint"})
    except Exception:
        pass
    led = _active_ledger
    if led is not None:
        led.lose("checkpointing", seconds)


def note_exposed_collective(seconds: float) -> None:
    """Split-phase overlap hook: attribute
    exposed collective wall time to the live step. The step carves it
    out of the enclosing ``compute`` phase at finish, so per-step phase
    sums still match wall time."""
    sp = _active_step
    if sp is not None:
        sp.note_exposed(seconds)


# ------------------------------------------------------------- step timer

class StepPhases:
    """One training step's phase ledger.

    Use the ``phase(name)`` context for timed sections, ``add`` for
    externally-measured durations; ``finish()`` observes each phase
    into ``rtpu_train_step_phase_seconds{phase}`` (exemplar-linked to
    the ambient trace, if any), records a ``train.step`` span, books
    the ledger, and publishes the row to the GCS step matrix.
    """

    def __init__(self, step: int, worker: str = "",
                 ledger: Optional[GoodputLedger] = None):
        global _active_step
        self.step = int(step)
        self.worker = str(worker)
        self._ledger = ledger
        self.durations: Dict[str, float] = {}
        self._exposed = 0.0
        self._start_ts = time.time()
        self._t0 = time.perf_counter()
        with _lock:
            _active_step = self

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        if name not in TRAIN_PHASES:
            raise ValueError(f"unknown train phase {name!r} "
                             f"(want one of {TRAIN_PHASES})")
        self.durations[name] = (self.durations.get(name, 0.0)
                                + max(float(seconds), 0.0))

    def note_exposed(self, seconds: float) -> None:
        self._exposed += max(float(seconds), 0.0)

    def finish(self, publish: bool = True) -> Dict[str, Any]:
        global _active_step
        wall = time.perf_counter() - self._t0
        with _lock:
            if _active_step is self:
                _active_step = None
        if self._exposed:
            # Exposed collective time happened INSIDE the timed compute
            # section; carve it out so phases partition the wall time.
            carve = min(self._exposed, self.durations.get("compute", 0.0))
            if carve:
                self.durations["compute"] -= carve
            self.add("exposed_collective", self._exposed)
        wall = max(wall, sum(self.durations.values()))

        trace_id = None
        try:
            from ray_tpu_torch.util.tracing import current_trace, record_span

            tc = current_trace()
            if tc is not None:
                trace_id = tc.trace_id
            attrs: Dict[str, Any] = {"step": self.step,
                                     "worker": self.worker}
            for phase, dur in self.durations.items():
                attrs[f"{phase}_s"] = round(dur, 6)
            record_span("train.step", self._start_ts, wall, attrs)
        except Exception:
            pass
        try:
            m = goodput_metrics()
            for phase, dur in self.durations.items():
                m.step_phase_seconds.observe(dur, {"phase": phase},
                                             trace_id=trace_id)
        except Exception:
            pass
        if self._ledger is not None:
            self._ledger.book_phases(self.durations)
        row = {
            "worker": self.worker, "step": self.step,
            "wall_s": wall, "phases": dict(self.durations),
            "ts": time.time(),
        }
        if self._ledger is not None:
            row["goodput"] = self._ledger.snapshot()
        if publish:
            publish_train_step(row)
        return row


# --------------------------------------------------------- GCS publication

def publish_train_step(row: Dict[str, Any]) -> bool:
    """Fire-and-forget report of one step row into the GCS step matrix
    (``report_train_steps``). Doubles as the worker's step heartbeat:
    the GCS stall watchdog times out workers whose rows stop arriving.
    Returns False (silently) outside a connected worker — plain
    ``run_pod_training()`` in a bare process still gets local metrics.
    """
    try:
        from ray_tpu_torch._private.worker import global_worker_or_none

        w = global_worker_or_none()
        if w is None or getattr(w, "_dead", False):
            return False
        payload = dict(row)
        payload.setdefault("worker_id", w.worker_id.binary())
        payload.setdefault("node_id", w.node_id)
        w.gcs.cast("report_train_steps", row=payload)
        return True
    except Exception:
        return False


def publish_train_done(worker: str) -> bool:
    """Mark a train worker's run complete so the stall watchdog stops
    expecting heartbeats from it (a finished run is not a stall)."""
    return publish_train_step({"worker": str(worker), "done": True})


# ------------------------------------------------------ straggler detector

class StragglerDetector:
    """Cross-worker step-time comparator over the step matrix.

    Keeps a bounded window of recent step walls and phase durations per
    worker; a worker whose windowed mean step time exceeds
    ``threshold``× the median of all workers' means is flagged. The
    flag names the *dominant phase*: the phase with the largest excess
    over the peer median of that phase — so a worker slowed by its
    input pipeline names ``data_wait`` even when everyone's ``compute``
    is larger in absolute terms. Re-flagging the same worker is
    suppressed for ``window`` further steps (one event per episode,
    not one per step).
    """

    def __init__(self, threshold: float = 1.5, window: int = 8,
                 min_workers: int = 2):
        self.threshold = float(threshold)
        self.window = max(int(window), 2)
        self.min_workers = max(int(min_workers), 2)
        self._walls: Dict[str, deque] = {}
        self._phases: Dict[str, Dict[str, deque]] = {}
        self._last_flag_step: Dict[str, int] = {}

    def observe(self, worker: str, step: int, wall_s: float,
                phases: Optional[Dict[str, float]] = None
                ) -> Optional[Dict[str, Any]]:
        """Feed one step row; returns a flag record when `worker` just
        crossed the straggler threshold, else None."""
        worker = str(worker)
        walls = self._walls.setdefault(worker,
                                       deque(maxlen=self.window))
        walls.append(max(float(wall_s), 0.0))
        per_phase = self._phases.setdefault(worker, {})
        for phase, dur in (phases or {}).items():
            per_phase.setdefault(
                phase, deque(maxlen=self.window)).append(float(dur))

        if len(self._walls) < self.min_workers:
            return None
        if len(walls) < max(2, self.window // 2):
            return None
        means = {w: sum(d) / len(d)
                 for w, d in self._walls.items() if d}
        median = _median(list(means.values()))
        mean_w = means[worker]
        if median <= 0 or mean_w <= self.threshold * median:
            self._last_flag_step.pop(worker, None)
            return None
        last = self._last_flag_step.get(worker)
        if last is not None and int(step) - last < self.window:
            return None
        self._last_flag_step[worker] = int(step)
        dominant, excess = self._dominant_phase(worker)
        return {
            "worker": worker, "step": int(step),
            "mean_step_s": mean_w, "median_step_s": median,
            "ratio": mean_w / median,
            "dominant_phase": dominant,
            "dominant_excess_s": excess,
        }

    def mean_step_s(self, worker: str) -> Optional[float]:
        d = self._walls.get(str(worker))
        return (sum(d) / len(d)) if d else None

    def _dominant_phase(self, worker: str):
        """Phase with the largest mean excess over the peer median."""
        phase_means: Dict[str, Dict[str, float]] = {}
        for w, per_phase in self._phases.items():
            for phase, d in per_phase.items():
                if d:
                    phase_means.setdefault(phase, {})[w] = \
                        sum(d) / len(d)
        best, best_excess = "", 0.0
        for phase, by_worker in phase_means.items():
            if worker not in by_worker:
                continue
            peer_median = _median(list(by_worker.values()))
            excess = by_worker[worker] - peer_median
            if excess > best_excess:
                best, best_excess = phase, excess
        if not best:
            # No phase data (or no excess): fall back to the biggest
            # absolute phase so the flag always names something.
            mine = {p: (sum(d) / len(d))
                    for p, d in self._phases.get(worker, {}).items() if d}
            if mine:
                best = max(mine, key=mine.get)
                best_excess = mine[best]
        return best, best_excess


def _median(values) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return float(ordered[mid - 1] + ordered[mid]) / 2.0
