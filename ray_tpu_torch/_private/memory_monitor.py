"""Node memory watchdog (reference: `src/ray/common/memory_monitor.h:52`
+ `raylet/worker_killing_policy.h:34`).

The reference polls cgroup/system memory inside the raylet and, above a
usage threshold, kills workers by policy — retriable tasks first, newest
first — so one leaky task degrades to a retry instead of the kernel OOM
killer taking down the raylet or an actor holding GPUs.

Usage source order: the test-injection file (if configured), cgroup v2
`memory.current/memory.max` (container limits beat host totals), then
psutil virtual memory.
"""

from __future__ import annotations

import os
from typing import Optional

_CGROUP_CUR = "/sys/fs/cgroup/memory.current"
_CGROUP_MAX = "/sys/fs/cgroup/memory.max"


def usage_fraction(test_path: str = "") -> Optional[float]:
    """Current memory usage in [0, 1], or None if undeterminable."""
    if test_path:
        try:
            with open(test_path) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return None
    try:
        with open(_CGROUP_CUR) as f:
            cur = int(f.read())
        with open(_CGROUP_MAX) as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            if limit > 0:
                return cur / limit
    except (OSError, ValueError):
        pass
    try:
        import psutil

        return psutil.virtual_memory().percent / 100.0
    except Exception:
        return None


def pick_victim(workers, busy_ids=frozenset(),
                rss=None) -> Optional[object]:
    """Worker-killing policy over _WorkerHandle values: leased task
    workers before actors (tasks retry for free; actors lose state);
    within a class, workers actually executing before idle-leased ones
    (killing a pool-idle worker frees no task memory); then largest
    resident set first — the kill should be attributed to the worker
    actually holding the memory, not whichever leased newest (observed:
    newest-lease-first shooting a 50 MB bystander while a 4 GB hog kept
    thrashing). ``busy_ids`` is the set of worker_ids observed executing
    (raylet probes `busy_info`); ``rss`` maps worker_id -> resident
    bytes (missing entries rank lowest). Lease recency breaks ties."""
    leased = [h for h in workers if h.lease is not None]
    if not leased:
        return None
    tasks = [h for h in leased if not h.is_actor]
    pool = tasks or leased
    rss = rss or {}
    return max(pool, key=lambda h: (getattr(h, "worker_id", None) in busy_ids,
                                    rss.get(getattr(h, "worker_id", None),
                                            0.0),
                                    getattr(h, "lease_ts", 0.0)))
