"""Daemon fate-sharing with the process that spawned it.

Reference analog: raylet/GCS exit when the session that started them goes
away (for `ray.init()`-started clusters the driver's atexit stops them —
but a SIGKILLed driver strands the daemons). Daemons poll the spawner's
pid and exit when it disappears, so killed test runs never leak a cluster.
"""

from __future__ import annotations

import os
import threading
import time


def watch_parent(pid: int, on_death=None, interval: float = 2.0) -> None:
    """Start a daemon thread that exits this process when `pid` dies."""
    if pid <= 0:
        return

    def _watch():
        while True:
            time.sleep(interval)
            try:
                os.kill(pid, 0)
            except OSError:
                if on_death is not None:
                    try:
                        on_death()
                    except Exception:
                        pass
                os._exit(0)

    threading.Thread(target=_watch, daemon=True,
                     name="fate-share-watch").start()
