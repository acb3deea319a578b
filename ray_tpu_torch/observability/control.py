"""Control-plane plumbing: the port's copy of
``ray_tpu/observability/control.py``.

- ``rtpu_ctrl_decisions_total{controller,action}``: one counter
  increment per decision (:func:`record_decision`), and a decision span
  (``ctrl:<controller>``) in the span buffer, so an action lines up with
  the load that caused it. The engine's preemption policy records one
  per checkpointed batch decode.
- :class:`Hysteresis`, the gate between "the metric moved" and "act on
  it": a proposed change must hold for a direction-specific delay, and
  actions are spaced by a cooldown.

The reference also ships each decision to the GCS decision ring and as a
typed cluster event when a worker is connected; the port has no worker
yet (its runtime is a later slice), so ``emit`` changes nothing here.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

_metrics = None


class ControlMetrics:
    """Lazy singleton, so importing this module registers no metric in
    processes that make no control decisions."""

    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter

        self.decisions = Counter(
            "ctrl_decisions_total",
            description="Control-plane decisions by controller and "
                        "action (autoscale, backpressure, preemption).",
            tag_keys=("controller", "action"))


def control_metrics() -> ControlMetrics:
    global _metrics
    if _metrics is None:
        _metrics = ControlMetrics()
    return _metrics


def record_decision(controller: str, action: str, reason: str,
                    reading: Optional[Dict[str, Any]] = None, *,
                    event_type: Optional[str] = None,
                    message: Optional[str] = None,
                    node_id: Optional[str] = None,
                    severity: Optional[str] = None,
                    emit: bool = True) -> Dict[str, Any]:
    """Record one control decision: increment the decision counter and
    record a ``ctrl:<controller>`` span carrying the reason and the
    triggering reading. Returns the payload the reference ships to the
    GCS decision ring (``event_type``, ``message`` and ``severity`` are
    its cluster event's; with no worker in the port they go nowhere)."""
    reading = dict(reading or {})
    payload = {"controller": controller, "action": action,
               "reason": reason, "reading": reading, "node_id": node_id}
    control_metrics().decisions.inc(
        1.0, tags={"controller": controller, "action": action})

    from ray_tpu_torch.util import tracing
    now = time.time()
    tracing.record_span(
        f"ctrl:{controller}", now, 0.0,
        attrs={"action": action, "reason": reason, **reading})
    return payload


class Hysteresis:
    """Hold-delay + cooldown gate for a controlled integer value.

    ``propose(current, desired, now)`` returns the value to act on:
    ``desired`` only once it has been continuously proposed for
    ``up_delay_s`` (increases) / ``down_delay_s`` (decreases) *and* at
    least ``cooldown_s`` has passed since the last granted change;
    ``current`` otherwise. A proposal that changes while held restarts
    its clock, so oscillation never accumulates toward an action.
    """

    def __init__(self, up_delay_s: float = 0.0,
                 down_delay_s: float = 0.0,
                 cooldown_s: float = 0.0):
        self.up_delay_s = float(up_delay_s)
        self.down_delay_s = float(down_delay_s)
        self.cooldown_s = float(cooldown_s)
        self._pending: Optional[Any] = None
        self._pending_since = 0.0
        self._last_action = 0.0

    def propose(self, current, desired, now: Optional[float] = None):
        now = time.time() if now is None else now
        if desired == current:
            self._pending = None
            return current
        if self._pending != desired:
            self._pending = desired
            self._pending_since = now
        delay = self.up_delay_s if desired > current else self.down_delay_s
        if now - self._pending_since < delay:
            return current
        if now - self._last_action < self.cooldown_s:
            return current
        self._pending = None
        self._last_action = now
        return desired

    def note_external_change(self, now: Optional[float] = None) -> None:
        """Start the cooldown window after a change made outside the
        gate (e.g. a redeploy reset the replica count)."""
        self._last_action = time.time() if now is None else now
        self._pending = None
