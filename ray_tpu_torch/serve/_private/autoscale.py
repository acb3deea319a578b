"""Serve replica autoscaling policy: the port's copy of
``ray_tpu/serve/_private/autoscale.py`` (reference:
`serve/_private/autoscaling_policy.py` — replica-count decisions from
aggregated ongoing-request metrics, with up/downscale delays).

Two signal families feed one decision:

- handle-side ongoing-request reports (always fresh — routers push
  every ~2s straight to the controller): the reference's
  ``target_ongoing_requests`` law, ``ceil(inflight / target)``.
- the observability plane through the MetricsHub: queue-wait p95 and
  slot-utilization gauges from the replicas' LLM engines. These catch
  what inflight counts cannot — requests admitted but *queued* inside
  a replica, and decode batches running full — and they come with
  explicit staleness: a reading whose sources stopped pushing makes
  the policy HOLD rather than act on a frozen number.

The decision then passes the shared :class:`~ray_tpu_torch.observability.
control.Hysteresis` gate (hold delays + cooldown), so an oscillating
gauge cannot flap the replica set.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.observability.control import Hysteresis

# Filled into every autoscaling_config by serve/api.py's spec build;
# schema.py validates user-supplied overrides against the same keys.
AUTOSCALING_DEFAULTS: Dict[str, Any] = {
    "min_replicas": 1,
    "max_replicas": 4,
    "target_ongoing_requests": 2,
    "upscale_delay_s": 2.0,
    "downscale_delay_s": 10.0,
    # Queue-wait p95 above this proposes one extra replica even when
    # inflight counts look fine (requests are aging inside replicas).
    "queue_wait_target_s": 0.5,
    # Mean batch utilization above this proposes one extra replica;
    # a saturated decode program serves at max latency.
    "slot_utilization_target": 0.9,
}


def validate_autoscaling_config(cfg: Dict[str, Any], *,
                                error_cls: type = ValueError) -> None:
    """Reject impossible autoscaling configs loudly (a min above max
    would otherwise pin the replica count silently)."""
    lo = cfg.get("min_replicas", AUTOSCALING_DEFAULTS["min_replicas"])
    hi = cfg.get("max_replicas", AUTOSCALING_DEFAULTS["max_replicas"])
    if not (isinstance(lo, int) and isinstance(hi, int)) or lo < 0:
        raise error_cls(
            f"autoscaling_config min_replicas/max_replicas must be "
            f"non-negative ints, got min_replicas={lo!r} "
            f"max_replicas={hi!r}")
    if lo > hi:
        raise error_cls(
            f"autoscaling_config min_replicas ({lo}) must be <= "
            f"max_replicas ({hi})")


class AutoscalePolicy:
    """Per-deployment desired-replica policy: signals -> clamp ->
    hysteresis gate. Pure against injected readings (unit tests feed a
    synthetic MetricsHub and clock)."""

    def __init__(self, cfg: Dict[str, Any],
                 cooldown_s: Optional[float] = None):
        self.cfg = dict(AUTOSCALING_DEFAULTS)
        self.cfg.update(cfg or {})
        validate_autoscaling_config(self.cfg)
        self.lo = self.cfg["min_replicas"]
        self.hi = self.cfg["max_replicas"]
        self.target = max(self.cfg["target_ongoing_requests"], 1e-9)
        if cooldown_s is None:
            from ray_tpu_torch._private.config import GlobalConfig
            cooldown_s = GlobalConfig.serve_autoscale_cooldown_s
        self.gate = Hysteresis(self.cfg["upscale_delay_s"],
                               self.cfg["downscale_delay_s"],
                               cooldown_s)

    def desired(self, current: int, inflight: int, hub=None,
                now: Optional[float] = None,
                window: float = 30.0) -> Tuple[int, Dict[str, Any]]:
        """Returns (replicas to converge to, the reading that decided).

        ``hub`` is a MetricsHub (or None when the metrics plane is not
        wired); series that are *absent* just don't contribute, series
        that are *stale* hold the whole decision.
        """
        now = time.time() if now is None else now
        reading: Dict[str, Any] = {"inflight": inflight,
                                   "current": current}
        if current == 0 and self.lo > 0:
            # Bootstrap, not a scale decision: a fresh deployment goes
            # straight to min_replicas without waiting out the gate.
            reading["desired"] = self.lo
            self.gate.note_external_change(now)
            return self.lo, reading

        raw = math.ceil(inflight / self.target)
        if hub is not None:
            qwait = hub.query("serve_queue_wait_seconds", window=window)
            util = hub.query("serve_batch_utilization", window=window)
            for series in (qwait, util):
                if series and series.stale():
                    reading["held"] = "stale_metrics"
                    reading["metric"] = series.name
                    reading["age_s"] = round(series.age_s or -1.0, 2)
                    return current, reading
            if qwait and (qwait.delta() or 0) > 0:
                p95 = qwait.quantile(0.95)
                reading["queue_wait_p95_s"] = p95
                if p95 is not None and \
                        p95 > self.cfg["queue_wait_target_s"]:
                    raw = max(raw, current + 1)
            if util and util.n_series:
                u = (util.latest or 0.0) / util.n_series
                reading["slot_utilization"] = round(u, 3)
                if u > self.cfg["slot_utilization_target"]:
                    raw = max(raw, current + 1)
        want = max(self.lo, min(self.hi, max(raw, 0)))
        reading["desired"] = want
        return self.gate.propose(current, want, now), reading
