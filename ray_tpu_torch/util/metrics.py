"""User-defined application metrics: the port's copy of
``ray_tpu/util/metrics.py`` (reference: Ray's ``python/ray/util/metrics.py``,
exported through the node MetricsAgent -> Prometheus there; here pushed
to the GCS metrics registry and served from the GCS ``/metrics`` scrape
endpoint alongside the system gauges).

Usage, as in the reference::

    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    requests = Counter("num_requests", description="...",
                       tag_keys=("route",))
    requests.inc(1.0, tags={"route": "/predict"})

Metrics are process-local (re-declaring a name aliases the first
instance's storage) and flushed to the GCS every
``GlobalConfig.metrics_report_interval_s`` seconds by a daemon thread
when the process has a worker attached; ``flush`` pushes at once and
returns False without one. Aggregation on the scrape side: counters and
histograms are summed across processes; gauges are exported per-process
with a ``pid`` label (summing gauges would be wrong). ``MetricsHub`` and
``query`` read the cluster aggregate back as windowed series with
explicit staleness (``ctrl_metrics_staleness_s``); ``local_summary``
reads this process's registry in the same shape.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}  # name -> canonical instance
_flusher_started = False

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
        _ensure_flusher()

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


# --------------------------------------------------------------------- flush

_flush_samplers: List = []


def register_flush_sampler(fn) -> None:
    """Register a callable invoked right before every metrics flush —
    the hook for sampled gauges (device memory, engine queue depth) that
    must be fresh at export time without their own timer threads."""
    with _registry_lock:
        if fn not in _flush_samplers:
            _flush_samplers.append(fn)
    _ensure_flusher()


def _run_samplers() -> None:
    for fn in list(_flush_samplers):
        try:
            fn()
        except Exception:
            pass  # a broken sampler must not stop the flush


def snapshot_records() -> List[Dict[str, object]]:
    """Serializable snapshots of every registered metric (for async push
    paths that cannot use the sync GCS client, e.g. worker kill)."""
    _run_samplers()
    with _registry_lock:
        return [m._snapshot() for m in _registry.values()]


def _flush_once() -> bool:
    """Push one snapshot of every registered metric to the GCS."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is None or getattr(w, "_dead", False):
        return False
    _run_samplers()
    with _registry_lock:
        snaps = [m._snapshot() for m in _registry.values()]
    if not snaps:
        return True
    try:
        w.gcs.call("push_metrics", source=metric_source(w),
                   records=snaps, timeout=5)
        return True
    except Exception:
        return False


def metric_source(worker) -> str:
    """Cluster-unique push key: bare pid collides across nodes."""
    wid = getattr(worker, "worker_id", None)
    suffix = wid.binary().hex()[:8] if wid is not None else "local"
    return f"{os.getpid()}@{suffix}"


def _ensure_flusher() -> None:
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def _loop():
        from ray_tpu_torch._private.config import GlobalConfig
        while True:
            time.sleep(GlobalConfig.metrics_report_interval_s)
            _flush_once()

    threading.Thread(target=_loop, daemon=True,
                     name="rtpu-metrics-flusher").start()


def flush() -> bool:
    """Force an immediate push (also called at worker shutdown/kill;
    SIGKILL'd workers lose at most one flush interval of updates)."""
    return _flush_once()


# ----------------------------------------------------------------- MetricsHub
#
# The query surface the control plane reads (serve autoscaler, data
# backpressure tuner, raylet memory preemption). One substrate: the GCS
# ``user_metrics_summary`` aggregate, polled into bounded time-windowed
# series with *explicit* staleness — a controller can always tell "the
# gauge is low" apart from "the gauge stopped updating", and must hold
# rather than act on the latter.

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_labels(label_str: str) -> Dict[str, str]:
    """``k="v",pid="123@ab"`` -> dict (the GCS summary data-key format)."""
    return {m.group(1): m.group(2).replace('\\"', '"').replace("\\\\", "\\")
            for m in _LABEL_RE.finditer(label_str or "")}


def _merge_hist(acc: Optional[Dict[str, Any]],
                cell: Dict[str, Any]) -> Dict[str, Any]:
    if acc is None:
        return {"count": float(cell.get("count", 0.0)),
                "sum": float(cell.get("sum", 0.0)),
                "buckets": {k: float(v)
                            for k, v in cell.get("buckets", {}).items()}}
    acc["count"] += float(cell.get("count", 0.0))
    acc["sum"] += float(cell.get("sum", 0.0))
    for k, v in cell.get("buckets", {}).items():
        acc["buckets"][k] = acc["buckets"].get(k, 0.0) + float(v)
    return acc


def _hist_sub(new: Dict[str, Any], old: Dict[str, Any]) -> Dict[str, Any]:
    """Windowed delta of two cumulative histogram snapshots. A negative
    count means the series reset (sources exited faster than tombstones
    accrued); fall back to the newest cumulative state."""
    delta = {"count": new["count"] - old["count"],
             "sum": new["sum"] - old["sum"],
             "buckets": {k: v - old["buckets"].get(k, 0.0)
                         for k, v in new["buckets"].items()}}
    if delta["count"] <= 0 or any(v < 0 for v in delta["buckets"].values()):
        return new
    return delta


class MetricSeries:
    """One queried metric: samples ``[(ts, value), ...]`` inside the
    window (newest last) plus explicit staleness. Gauge/counter values
    are floats; histogram values are ``{count, sum, buckets}`` dicts of
    cumulative state."""

    def __init__(self, name: str, mtype: Optional[str],
                 samples: List[Tuple[float, Any]],
                 age_s: Optional[float], n_series: int = 0):
        self.name = name
        self.type = mtype
        self.samples = samples
        #: Seconds since the freshest *source push* contributing to the
        #: newest sample (GCS-side age + time since the hub last fetched).
        #: ``None`` when the metric has never been observed.
        self.age_s = age_s
        #: How many label-sets were aggregated into each sample.
        self.n_series = n_series

    def __bool__(self) -> bool:
        return bool(self.samples)

    @property
    def latest(self):
        return self.samples[-1][1] if self.samples else None

    def stale(self, ttl: Optional[float] = None) -> bool:
        """True when the newest contributing push is older than ``ttl``
        (default ``GlobalConfig.ctrl_metrics_staleness_s``). A series
        with no samples at all is *absent*, not stale — test with
        ``bool(series)`` first; controllers treat absent as "signal not
        wired" and stale as "signal broken, hold"."""
        if not self.samples:
            return False
        if ttl is None:
            from ray_tpu_torch._private.config import GlobalConfig
            ttl = GlobalConfig.ctrl_metrics_staleness_s
        return self.age_s is None or self.age_s > ttl

    def mean(self) -> Optional[float]:
        """Mean gauge/counter value over the window (histograms: mean
        observation of the newest cumulative snapshot)."""
        if not self.samples:
            return None
        if self.type == "histogram":
            cell = self.samples[-1][1]
            return cell["sum"] / cell["count"] if cell["count"] else 0.0
        vals = [v for _, v in self.samples]
        return sum(vals) / len(vals)

    def delta(self) -> Optional[float]:
        """Increase across the window (counters / histogram counts)."""
        if not self.samples:
            return None
        new, old = self.samples[-1][1], self.samples[0][1]
        if self.type == "histogram":
            return max(0.0, new["count"] - old["count"])
        return max(0.0, float(new) - float(old))

    def rate(self) -> Optional[float]:
        """delta() / window span; None with fewer than two samples."""
        if len(self.samples) < 2:
            return None
        span = self.samples[-1][0] - self.samples[0][0]
        d = self.delta()
        return (d / span) if span > 0 and d is not None else None

    def quantile(self, q: float) -> Optional[float]:
        """Histogram quantile over the window (delta of the oldest vs
        newest cumulative snapshot; single-sample series use lifetime
        state). Returns the smallest bucket boundary covering ``q`` of
        observations — the Prometheus ``histogram_quantile`` estimate
        without interpolation, which is all hysteresis needs."""
        if self.type != "histogram" or not self.samples:
            return None
        cell = self.samples[-1][1]
        if len(self.samples) > 1:
            cell = _hist_sub(cell, self.samples[0][1])
        count = cell["count"]
        if not count:
            return None
        target = q * count
        for bound, cum in sorted(cell["buckets"].items(),
                                 key=lambda kv: float(kv[0])):
            if cum >= target:
                return float(bound)
        # Beyond the last boundary (+inf bucket): the largest finite
        # boundary is the best lower bound we can report.
        bounds = [float(b) for b in cell["buckets"]]
        return max(bounds) if bounds else None


class MetricsHub:
    """Windowed, staleness-aware client over the cluster metrics plane.

    ``fetch(prefixes)`` returns a ``user_metrics_summary``-shaped dict
    (default: the GCS RPC through the global worker; the data
    backpressure tuner plugs in :func:`local_summary` to read its own
    process registry with zero RPCs). ``refresh()`` is rate-limited, so
    controllers may call it every tick; samples are pruned beyond
    ``history_s``."""

    def __init__(self, fetch=None, history_s: float = 600.0,
                 min_refresh_s: float = 0.5):
        self._fetch = fetch or _gcs_summary
        self._history_s = history_s
        self._min_refresh_s = min_refresh_s
        self._lock = threading.Lock()
        # (name, label_str) -> deque[(ts, value)]
        self._series: Dict[Tuple[str, str], deque] = {}
        self._meta: Dict[str, Dict[str, Any]] = {}
        self._server_age: Dict[str, Optional[float]] = {}
        self._last_refresh = 0.0

    def refresh(self, prefixes: Optional[Sequence[str]] = None,
                force: bool = False) -> bool:
        now = time.time()
        with self._lock:
            if not force and now - self._last_refresh < self._min_refresh_s:
                return True
            self._last_refresh = now
        try:
            summary = self._fetch(list(prefixes) if prefixes else None)
        except Exception:
            return False
        if summary is None:
            return False
        self.ingest(summary, ts=now)
        return True

    def ingest(self, summary: Dict[str, Any],
               ts: Optional[float] = None) -> None:
        """Append one summary snapshot (also the unit-test entry point:
        feed synthetic snapshots, no cluster required)."""
        ts = time.time() if ts is None else ts
        horizon = ts - self._history_s
        with self._lock:
            for name, entry in summary.items():
                self._meta[name] = {
                    "type": entry.get("type"),
                    "boundaries": entry.get("boundaries")}
                self._server_age[name] = entry.get("age_s")
                for label_str, cell in (entry.get("data") or {}).items():
                    dq = self._series.setdefault((name, label_str), deque())
                    dq.append((ts, cell))
                    while dq and dq[0][0] < horizon:
                        dq.popleft()

    def query(self, name: str, window: Optional[float] = None,
              labels: Optional[Dict[str, str]] = None) -> MetricSeries:
        """Aggregate every stored label-set of ``name`` whose labels are
        a superset of ``labels`` into one windowed series. Counters and
        histograms sum across label-sets; gauges sum too (the per-pid
        gauge split means "sum over processes" is the cluster total —
        pass ``labels={"pid": ...}`` for a single process). ``name``
        accepts the exported ``rtpu_`` prefix."""
        if name.startswith("rtpu_"):
            name = name[len("rtpu_"):]
        now = time.time()
        cutoff = (now - window) if window else None
        with self._lock:
            meta = self._meta.get(name)
            mtype = meta["type"] if meta else None
            merged: Dict[float, Any] = {}
            n_series = 0
            for (sname, label_str), dq in self._series.items():
                if sname != name:
                    continue
                if labels:
                    parsed = parse_labels(label_str)
                    if any(parsed.get(k) != str(v)
                           for k, v in labels.items()):
                        continue
                n_series += 1
                for sts, cell in dq:
                    if cutoff is not None and sts < cutoff:
                        continue
                    if mtype == "histogram":
                        merged[sts] = _merge_hist(merged.get(sts), cell)
                    else:
                        merged[sts] = merged.get(sts, 0.0) + float(cell)
            server_age = self._server_age.get(name)
            fetched = self._last_refresh
        samples = sorted(merged.items())
        age = None
        if samples:
            age = max(0.0, now - fetched) + (server_age or 0.0)
        return MetricSeries(name, mtype, samples, age, n_series)


def _gcs_summary(prefixes: Optional[List[str]]):
    """Default hub fetch: the GCS aggregate through the global worker."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is None or getattr(w, "_dead", False):
        return None
    return w.gcs.call("user_metrics_summary", prefixes=prefixes, timeout=5)


def local_summary(prefixes: Optional[List[str]] = None) -> Dict[str, Any]:
    """This process's registry in ``user_metrics_summary`` shape — the
    zero-RPC hub fetch for in-process controllers (the data executors
    tune against gauges *they* set; a GCS round-trip would only add the
    flush interval as control latency). ``age_s`` is 0: local reads are
    fresh by construction."""
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


_global_hub: Optional[MetricsHub] = None


def global_hub() -> MetricsHub:
    global _global_hub
    with _registry_lock:
        if _global_hub is None:
            _global_hub = MetricsHub()
        return _global_hub


def query(name: str, window: Optional[float] = None,
          labels: Optional[Dict[str, str]] = None) -> MetricSeries:
    """Query the cluster metrics plane: ``query("serve_queue_wait_seconds",
    window=30).quantile(0.95)``. Refreshes the process-global hub from
    the GCS (rate-limited) and returns a windowed, staleness-aware
    series — the controllers' one shared read path."""
    hub = global_hub()
    hub.refresh()
    return hub.query(name, window=window, labels=labels)
