"""Control-plane plumbing: the port's copy of
``ray_tpu/observability/control.py``.

What keeps the controllers' *decisions* (the serve autoscaler, the
engine's preemption policy) as observable as the metrics they read:

- ``rtpu_ctrl_decisions_total{controller,action}``: one counter
  increment per decision (:func:`record_decision`), from whichever
  process decided.
- a decision span (``ctrl:<controller>``), so an action lines up with
  the load that caused it.
- with a worker attached, a typed cluster event (AUTOSCALE_UP/DOWN, ...)
  carrying the triggering reading, and the GCS decision ring
  (``list_ctrl_decisions``).

It also hosts :class:`Hysteresis`, the gate between "the metric moved"
and "act on it": a proposed change must hold for a direction-specific
delay, and actions are spaced by a cooldown.
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
    """Record one control decision everywhere it is observable.

    Always increments the decision counter and records a
    ``ctrl:<controller>`` span carrying the reason and the triggering
    reading. With ``emit=True`` and a live global worker, also ships the
    cluster event and the GCS decision-ring entry synchronously; async
    callers with their own GCS client pass ``emit=False`` and forward
    the returned payload themselves."""
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

    if not emit:
        return payload

    from ray_tpu_torch._private.worker import global_worker_or_none
    w = global_worker_or_none()
    if w is None or getattr(w, "_dead", False):
        return payload
    try:
        w.gcs.call("report_ctrl_decision", timeout=5, **payload)
        if event_type is not None:
            w.gcs.call(
                "report_cluster_event", event_type=event_type,
                message=message or f"{controller}: {action} ({reason})",
                severity=severity, node_id=node_id,
                extra={"controller": controller, "action": action,
                       **reading}, timeout=5)
    except Exception:
        pass  # decisions must never take down the deciding loop
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
