"""Object-store instrumentation: per-node memory-pressure metric set.

The store itself lives inside the raylet process; its stats are sampled
through the shared ``register_flush_sampler`` hook — the sampler reads
``NodeObjectStore.stats()`` right before every metrics flush, sets the
gauges, and advances the cumulative counters by the delta since the last
sample (the store keeps plain ints; Prometheus counters must only ever
``inc``).  The raylet's reporter loop pushes the resulting snapshots to
the GCS, whose tombstone folding keeps the counters monotone across
raylet exit (totals never regress on node churn).

Gauges are per-node labeled (``node=<node_id[:12]>``); NOT ``pid`` — the
gauge renderer appends its own ``pid=<source>`` label and duplicate
label names break the whole Prometheus scrape.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

_singleton = None
_lock = threading.Lock()


class ObjectStoreMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge

        node = ("node",)
        self.capacity = Gauge(
            "object_store_capacity_bytes", tag_keys=node,
            description="Shared-memory store capacity on the node.")
        self.used = Gauge(
            "object_store_used_bytes", tag_keys=node,
            description="Shared-memory bytes currently allocated.")
        self.num_objects = Gauge(
            "object_store_num_objects", tag_keys=node,
            description="Objects tracked by the node store (including "
                        "spilled entries).")
        self.pinned = Gauge(
            "object_store_pinned_bytes", tag_keys=node,
            description="Bytes of in-memory primary copies pinned "
                        "against eviction.")
        self.spilled = Gauge(
            "object_store_spilled_bytes", tag_keys=node,
            description="Bytes currently spilled to disk.")
        self.spills = Counter(
            "object_store_spills_total", tag_keys=node,
            description="Objects spilled to disk under memory pressure.")
        self.restores = Counter(
            "object_store_restores_total", tag_keys=node,
            description="Spilled objects restored into shared memory.")
        self.evictions = Counter(
            "object_store_evictions_total", tag_keys=node,
            description="Unpinned secondary copies evicted (dropped).")
        self.spill_time = Counter(
            "object_store_spill_seconds_total", tag_keys=node,
            description="Cumulative wall time spent writing spill files.")
        self.restore_time = Counter(
            "object_store_restore_seconds_total", tag_keys=node,
            description="Cumulative wall time spent restoring spill "
                        "files.")


def object_store_metrics() -> ObjectStoreMetrics:
    global _singleton
    with _lock:
        if _singleton is None:
            _singleton = ObjectStoreMetrics()
        return _singleton


# stats() key -> (metric attr, is_counter)
_FIELDS = (
    ("capacity", "capacity", False),
    ("used", "used", False),
    ("num_objects", "num_objects", False),
    ("pinned_bytes", "pinned", False),
    ("spilled_bytes", "spilled", False),
    ("num_spills", "spills", True),
    ("num_restores", "restores", True),
    ("num_evictions", "evictions", True),
    ("spill_time_s", "spill_time", True),
    ("restore_time_s", "restore_time", True),
)


def register_store_sampler(get_stats: Callable[[], Dict],
                           node: str) -> Callable[[], None]:
    """Register a flush sampler exporting one store's stats snapshot.

    ``get_stats`` is called at every metrics flush; counter fields
    advance by their delta since the previous sample so the exported
    series stay monotone even though the store keeps raw totals.
    Returns the sampler (tests call it directly to force a sample).
    """
    from ray_tpu_torch.util.metrics import register_flush_sampler

    m = object_store_metrics()
    tags = {"node": node}
    last: Dict[str, float] = {}

    def sample() -> None:
        stats = get_stats()
        for key, attr, is_counter in _FIELDS:
            val = float(stats.get(key, 0))
            metric = getattr(m, attr)
            if is_counter:
                delta = val - last.get(key, 0.0)
                if delta > 0:
                    metric.inc(delta, tags=tags)
                last[key] = val
            else:
                metric.set(val, tags=tags)

    register_flush_sampler(sample)
    return sample
