"""User-defined application metrics: the port's copy of
``ray_tpu/util/metrics.py`` (reference: Ray's ``python/ray/util/metrics.py``).

Usage, as in the reference::

    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    requests = Counter("num_requests", description="...",
                       tag_keys=("route",))
    requests.inc(1.0, tags={"route": "/predict"})

Metrics live in one process-local registry: re-declaring a name aliases
the first instance's storage. ``snapshot_records`` and ``local_summary``
read it (the serving engine's token reconciliation reads the latter).

Not here yet, because they need the port's runtime (the GCS and a
worker): the flusher thread that pushes snapshots to the GCS every
``metrics_report_interval_s`` (``_flush_once``, ``flush``,
``metric_source``), and the ``MetricsHub``/``query`` read path over the
cluster aggregate. Until then nothing leaves the process.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}  # name -> canonical instance

DEFAULT_BOUNDARIES = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _valid_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    if not out or out[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")
    return out


class Metric:
    """Base class; do not instantiate directly."""

    _type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if tag_keys is not None and not all(
                isinstance(k, str) for k in tag_keys):
            raise TypeError("tag_keys must be strings")
        self._name = _valid_name(name)
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        # tag-value tuple (aligned with _tag_keys) -> float / bucket list
        self._data: Dict[Tuple[str, ...], object] = {}
        # tag-value tuple -> {"trace_id", "value", "ts"}: the max-valued
        # exemplar per label set (histograms only; see Histogram.observe).
        self._exemplars: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        # Re-creating a metric with the same name (e.g. inside a task body
        # run many times on one worker) aliases the canonical instance's
        # storage instead of growing the registry without bound.
        with _registry_lock:
            prior = _registry.get(self._name)
            if prior is not None:
                if (prior._type != self._type
                        or prior._tag_keys != self._tag_keys
                        or getattr(prior, "boundaries", None)
                        != getattr(self, "boundaries", None)):
                    raise ValueError(
                        f"metric {self._name!r} already registered with a "
                        f"different type/tag_keys/boundaries")
                self._data = prior._data
                self._lock = prior._lock
                if not hasattr(prior, "_exemplars"):
                    prior._exemplars = {}
                self._exemplars = prior._exemplars
            else:
                _registry[self._name] = self

    # Reference parity: metric.set_default_tags({...}) returns self.
    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    @property
    def info(self) -> Dict[str, object]:
        return {"name": self._name, "type": self._type,
                "description": self._description,
                "tag_keys": self._tag_keys,
                "default_tags": dict(self._default_tags)}

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self._tag_keys)
        if extra:
            raise ValueError(
                f"unknown tag(s) {sorted(extra)} for metric {self._name!r}; "
                f"declared tag_keys={self._tag_keys}")
        vals = tuple(str(merged.get(k, "")) for k in self._tag_keys)
        if any("," in v for v in vals):
            raise ValueError("tag values must not contain ','")
        return vals

    def _snapshot(self) -> Dict[str, object]:
        with self._lock:
            data = {",".join(k): v if not isinstance(v, list) else list(v)
                    for k, v in self._data.items()}
            exemplars = {",".join(k): dict(v)
                         for k, v in self._exemplars.items()}
        snap = {**self.info, "data": data}
        if exemplars:
            snap["exemplars"] = exemplars
        return snap


class Counter(Metric):
    """Monotonically increasing counter (summed across processes)."""

    _type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() requires value >= 0")
        key = self._tag_tuple(tags)
        with self._lock:
            self._data[key] = float(self._data.get(key, 0.0)) + value


class Gauge(Metric):
    """Last-write-wins value (exported per-process)."""

    _type = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._data[self._tag_tuple(tags)] = float(value)


class Histogram(Metric):
    """Cumulative-bucket histogram, Prometheus exposition semantics."""

    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        self.boundaries = tuple(
            sorted(boundaries if boundaries else DEFAULT_BOUNDARIES))
        if any(b <= 0 for b in self.boundaries):
            raise ValueError("histogram boundaries must be > 0")
        super().__init__(name, description, tag_keys)

    @property
    def info(self) -> Dict[str, object]:
        out = super().info
        out["boundaries"] = self.boundaries
        return out

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None, *,
                trace_id: Optional[str] = None) -> None:
        """Record one observation. ``trace_id`` optionally links an
        exemplar: per label set, the max-valued observation's trace_id
        is kept (replaced when a new value >= the stored one), so a
        latency histogram points straight at the slowest request's
        retrievable trace. The exemplar rides a dedicated kwarg — it
        never widens the declared tag_keys / label set."""
        key = self._tag_tuple(tags)
        with self._lock:
            cell = self._data.get(key)
            if cell is None:
                # [bucket_0..bucket_n-1, +inf, sum, count]
                cell = [0.0] * (len(self.boundaries) + 3)
                self._data[key] = cell
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    cell[i] += 1
            cell[len(self.boundaries)] += 1          # +inf bucket
            cell[len(self.boundaries) + 1] += value  # sum
            cell[len(self.boundaries) + 2] += 1      # count
            if trace_id is not None:
                prior = self._exemplars.get(key)
                if prior is None or float(value) >= prior["value"]:
                    self._exemplars[key] = {
                        "trace_id": str(trace_id),
                        "value": float(value), "ts": time.time()}


# --------------------------------------------------------------- snapshots

_flush_samplers: List = []


def register_flush_sampler(fn) -> None:
    """Register a callable invoked right before every snapshot — the
    hook for sampled gauges (device memory, engine queue depth) that
    must be fresh when read, without timer threads of their own."""
    with _registry_lock:
        if fn not in _flush_samplers:
            _flush_samplers.append(fn)


def _run_samplers() -> None:
    for fn in list(_flush_samplers):
        try:
            fn()
        except Exception:
            pass  # a broken sampler must not stop the snapshot


def snapshot_records() -> List[Dict[str, object]]:
    """Serializable snapshots of every registered metric."""
    _run_samplers()
    with _registry_lock:
        return [m._snapshot() for m in _registry.values()]


def local_summary(prefixes: Optional[List[str]] = None) -> Dict[str, Any]:
    """This process's registry in the reference's
    ``user_metrics_summary`` shape: {name: {type, description, age_s,
    data: {label string: value or histogram cell}}}. ``age_s`` is 0:
    local reads are fresh by construction."""
    out: Dict[str, Any] = {}
    for rec in snapshot_records():
        name, typ = rec["name"], rec["type"]
        if prefixes and not any(name.startswith(p) for p in prefixes):
            continue
        keys = rec.get("tag_keys", ())
        data: Dict[str, Any] = {}
        for tagvals, cell in rec.get("data", {}).items():
            label_str = ",".join(
                f'{k}="{v}"' for k, v in
                zip(keys, tagvals.split(",") if keys else ()))
            if typ == "histogram":
                bounds = tuple(rec.get("boundaries", ()))
                if len(cell) != len(bounds) + 3:
                    continue
                count = cell[len(bounds) + 2]
                total = cell[len(bounds) + 1]
                data[label_str] = {
                    "count": count, "sum": total,
                    "mean": (total / count) if count else 0.0,
                    "buckets": {str(b): cell[i]
                                for i, b in enumerate(bounds)}}
            else:
                data[label_str] = float(cell)
        entry: Dict[str, Any] = {"type": typ,
                                 "description": rec.get("description", ""),
                                 "age_s": 0.0, "data": data}
        if typ == "histogram":
            entry["boundaries"] = list(rec.get("boundaries", ()))
        out[name] = entry
    return out
