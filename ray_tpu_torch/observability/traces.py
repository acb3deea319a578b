"""Tail-sampled trace store — the GCS-side home of request traces.

Trace-tagged SPAN events arrive with every ``push_task_events`` batch
and accumulate per trace_id. Nothing is kept or dropped until the trace
*completes* (its root span, tagged ``attrs["trace_root"]``, arrives) —
that is tail-sampling, the property head-sampling cannot give: the
decision sees the whole trace, so every slow or failed request survives
(they are the ones worth explaining) while fast, clean traffic is
down-sampled to ``trace_sample_rate`` to bound memory.

Everything is bounded: kept traces ride an LRU ring of ``maxlen``,
incomplete traces are capped at ``pending_max`` (evicting oldest-first —
a crashed hop that never sends its root cannot leak), and per-trace span
counts are capped. All drops are counted, never silent.
"""

from __future__ import annotations

import random
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

# A trace with more spans than this is a runaway loop, not a request;
# further spans are counted as dropped.
MAX_SPANS_PER_TRACE = 2048


def _normalize(event: Dict[str, Any]) -> Dict[str, Any]:
    """Span events carry binary task ids (ring-buffer format); the trace
    store is read by the dashboard's JSON layer, so normalize on entry."""
    tid = event.get("task_id")
    return {
        "trace_id": event.get("trace_id"),
        "span_id": event.get("span_id"),
        "parent_span_id": event.get("parent_span_id"),
        "name": event.get("name"),
        "ts": event.get("ts"),
        "dur": event.get("dur", 0.0),
        "attrs": dict(event.get("attrs") or {}),
        "owner_pid": event.get("owner_pid"),
        "task_id": tid.hex() if isinstance(tid, bytes) else tid,
    }


class TraceStore:
    """Bounded accumulation + tail-sampling. Single-threaded by design:
    the GCS handler loop is the only caller (same discipline as the
    task-event and cluster-event rings)."""

    def __init__(self, maxlen: int = 512,
                 keep_threshold_s: float = 0.5,
                 sample_rate: float = 0.01,
                 pending_max: Optional[int] = None,
                 rng: Optional[random.Random] = None):
        self.maxlen = int(maxlen)
        self.keep_threshold_s = float(keep_threshold_s)
        self.sample_rate = float(sample_rate)
        self.pending_max = int(pending_max if pending_max is not None
                               else 4 * self.maxlen)
        self._rng = rng if rng is not None else random.Random()
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._pending: "OrderedDict[str, List[Dict[str, Any]]]" = \
            OrderedDict()
        self.kept = 0
        self.sampled_out = 0
        self.evicted_pending = 0
        self.evicted_kept = 0
        self.spans_seen = 0
        self.spans_dropped = 0

    def add_span(self, event: Dict[str, Any]) -> None:
        trace_id = event.get("trace_id")
        if not trace_id or not event.get("span_id"):
            return
        self.spans_seen += 1
        span = _normalize(event)
        kept = self._traces.get(trace_id)
        if kept is not None:
            # Late arrival for a kept trace (other processes flush on
            # their own cadence) — attach, keeping the bound.
            if len(kept["spans"]) < MAX_SPANS_PER_TRACE:
                kept["spans"].append(span)
                kept["error"] = kept["error"] or \
                    bool(span["attrs"].get("error"))
            else:
                self.spans_dropped += 1
            return
        buf = self._pending.get(trace_id)
        if buf is None:
            buf = self._pending[trace_id] = []
            while len(self._pending) > self.pending_max:
                self._pending.popitem(last=False)
                self.evicted_pending += 1
        if len(buf) >= MAX_SPANS_PER_TRACE:
            self.spans_dropped += 1
            return
        buf.append(span)
        if span["attrs"].get("trace_root"):
            self._complete(trace_id, span)

    def _complete(self, trace_id: str, root: Dict[str, Any]) -> None:
        spans = self._pending.pop(trace_id, [])
        error = any(s["attrs"].get("error") for s in spans)
        if root["dur"] >= self.keep_threshold_s:
            reason = "slow"
        elif error:
            reason = "error"
        elif self._rng.random() < self.sample_rate:
            reason = "sampled"
        else:
            self.sampled_out += 1
            return
        self.kept += 1
        self._traces[trace_id] = {
            "trace_id": trace_id,
            "root_name": root["name"],
            "ts": root["ts"],
            "dur": root["dur"],
            "error": error,
            "keep_reason": reason,
            "spans": spans,
        }
        while len(self._traces) > self.maxlen:
            self._traces.popitem(last=False)
            self.evicted_kept += 1

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """A kept trace, or the partial accumulation of an in-flight one
        (``complete`` False) so debugging does not wait on sampling."""
        kept = self._traces.get(trace_id)
        if kept is not None:
            return {**kept, "complete": True}
        buf = self._pending.get(trace_id)
        if buf:
            return {"trace_id": trace_id, "root_name": None,
                    "ts": buf[0]["ts"], "dur": 0.0, "error": False,
                    "keep_reason": None, "spans": list(buf),
                    "complete": False}
        return None

    def summaries(self, limit: int = 100) -> List[Dict[str, Any]]:
        out = []
        for tr in reversed(self._traces.values()):
            out.append({k: tr[k] for k in
                        ("trace_id", "root_name", "ts", "dur", "error",
                         "keep_reason")} | {"num_spans": len(tr["spans"])})
            if len(out) >= limit:
                break
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "kept": self.kept, "sampled_out": self.sampled_out,
            "evicted_pending": self.evicted_pending,
            "evicted_kept": self.evicted_kept,
            "spans_seen": self.spans_seen,
            "spans_dropped": self.spans_dropped,
            "pending": len(self._pending), "stored": len(self._traces),
            "ts": time.time(),
        }
