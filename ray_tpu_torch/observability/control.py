"""Control-plane gates: the port's copy of ``Hysteresis``
(``ray_tpu/observability/control.py``). The reference module also records
each controller's decisions (a counter, a timeline span, a cluster
event); that comes with the port's observability slice.
"""

from __future__ import annotations

import time
from typing import Any, Optional


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
