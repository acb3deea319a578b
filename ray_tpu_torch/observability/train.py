"""Training instrumentation: train sessions and RLlib learners (the
port's copy of ``ray_tpu/observability/train.py``; the port's RLlib, the
learners' driver, comes with the RLlib slice).

Two singletons feeding the same registry the serving metrics use:

- :func:`train_metrics` — driven by ``train.report()`` in each train
  worker: inter-report step duration, reports, samples/sec and loss
  when the user's metrics dict carries them.
- :func:`learner_metrics` — driven by ``rllib.core.Learner.update()``
  (the jitted SPMD step, gradient psum included) and
  ``LearnerGroup.update()`` (the distributed lockstep step across the
  learner fleet) in the reference.

Step-duration histograms use coarser boundaries than the serving set:
training steps live in the 10ms..minutes range.

The per-step *phase* decomposition (data-wait/h2d/compute/...), the
goodput ledger, and the cross-worker step matrix live next door in
``observability.goodput``; :func:`record_report_step` is the bridge
for report-driven user loops — each ``train.report()`` gap doubles as
a step-heartbeat row so the GCS straggler detector and stall watchdog
cover custom loops that never touch ``StepPhases``.
"""

from __future__ import annotations

import threading

_train = None
_learner = None
_lock = threading.Lock()

_STEP_BOUNDARIES = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
                    60.0, 300.0)


class TrainMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        self.reports = Counter(
            "train_reports_total",
            description="train.report() calls across train workers.")
        self.step_seconds = Histogram(
            "train_step_seconds", boundaries=_STEP_BOUNDARIES,
            description="Wall time between consecutive train.report() "
                        "calls (one training step per report).")
        self.samples_per_sec = Gauge(
            "train_samples_per_sec",
            description="Reported samples per second (needs a "
                        "samples-like key in the metrics dict).")
        self.loss = Gauge(
            "train_loss",
            description="Most recent reported loss per train worker.")


class LearnerMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        self.updates = Counter(
            "learner_updates_total",
            description="Learner gradient updates (per learner "
                        "process).")
        self.update_seconds = Histogram(
            "learner_update_seconds", boundaries=_STEP_BOUNDARIES,
            description="Wall time of one jitted SPMD update "
                        "(gradient psum included).")
        self.samples = Counter(
            "learner_samples_total",
            description="Samples consumed by learner updates.")
        self.loss = Gauge(
            "learner_loss",
            description="total_loss of the most recent update.")
        self.group_update_seconds = Histogram(
            "learner_group_update_seconds", boundaries=_STEP_BOUNDARIES,
            description="Wall time of one LearnerGroup lockstep update "
                        "across the fleet.")


def train_metrics() -> TrainMetrics:
    global _train
    with _lock:
        if _train is None:
            _train = TrainMetrics()
        return _train


def learner_metrics() -> LearnerMetrics:
    global _learner
    with _lock:
        if _learner is None:
            _learner = LearnerMetrics()
        return _learner


def record_report_step(rank: int, step: int,
                       step_s: "float | None") -> None:
    """Publish one report-driven step row into the GCS step matrix.

    Called by the train session per ``train.report()`` with the
    inter-report gap: no phase breakdown (the user loop is opaque),
    but the row IS the worker's step heartbeat — a custom loop that
    stops reporting trips the stall watchdog, and one consistently
    slower than its peers is flagged TRAIN_STRAGGLER on wall time.
    """
    try:
        from ray_tpu_torch.observability.goodput import (
            goodput_enabled, publish_train_step)

        if step_s is None or not goodput_enabled():
            return
        publish_train_step({
            "worker": f"rank{int(rank)}", "step": int(step),
            "wall_s": float(step_s), "phases": {},
        })
    except Exception:
        pass  # telemetry must never fail a training step


def batch_num_samples(batch) -> int:
    """Leading-dim size of the first leaf (nested multi-agent batches
    count their first module's rows — a stable per-step proxy)."""
    try:
        from torch.utils._pytree import tree_leaves

        leaves = tree_leaves(batch)
        return int(len(leaves[0])) if leaves else 0
    except Exception:
        return 0
