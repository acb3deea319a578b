"""Request-scoped tracing: the port's copy of ``ray_tpu/util/tracing.py``
(reference: Ray's ``python/ray/util/tracing/tracing_helper.py``).

A ``TraceContext`` (trace_id / span_id / parent_span_id / baggage) rides
a contextvar inside a process, and a compact wire dict (``{"t", "s",
"b"}``) across hops, so spans recorded downstream parent under the span
that was active when the work was submitted. ``span`` and ``trace_root``
open spans around a block; ``record_span`` records one with an explicit
start and duration (the serving engine rebuilds a request's queued,
prefill and decode phases that way, on its scheduler thread).
``build_trace_tree`` and ``critical_path`` read a trace back.

Typical use::

    from ray_tpu_torch.util import tracing

    with tracing.trace_root("serve.request") as tc:
        with tracing.span("route"):
            out = server(request)          # the engine parents under it
    tree = tracing.build_trace_tree(tracing.span_events(tc.trace_id))

Where the spans go. In a process with a worker attached (a driver
after ``ray_tpu_torch.init()``, a task or an actor), ``record_span``
appends each SPAN event to the worker's ``_task_events`` buffer, as the
reference does: the worker pushes it to the GCS (task events and the
tail-sampled trace store), where ``util.state.get_trace`` reads it back,
and a traced span nudges that push to come within half a second. In a
process without a worker, where the reference records nothing, the port
appends the same event dict to a process-local buffer bounded at
``SPAN_BUFFER_SIZE`` events (the oldest drop first): ``span_events``
reads it, ``drain_span_events`` empties it, and ``span_tree`` builds the
reference's cross-task tree from it. Such an event is recorded under
``SPAN_TASK_ID``, the task id the reference gives spans recorded outside
any task.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

# The process-local span buffer (the worker's task-event buffer in the
# reference): bounded, oldest first out.
SPAN_BUFFER_SIZE = 100_000
_span_lock = threading.Lock()
_spans: deque = deque(maxlen=SPAN_BUFFER_SIZE)
# The task id of a span recorded outside any task (the reference's).
SPAN_TASK_ID = b"driver"

# ------------------------------------------------------------- context


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class TraceContext:
    """One hop of a request-scoped trace. ``span_id`` is the identity of
    the currently-active span; anything recorded beneath it parents
    there. ``baggage`` is small propagated metadata (e.g. SLO lane) —
    copied, never merged, on each hop."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    baggage: Dict[str, Any] = field(default_factory=dict)

    def to_wire(self) -> Dict[str, Any]:
        """Compact dict for the TaskSpec. The parent link never travels:
        the receiver parents to the sender's span itself."""
        return {"t": self.trace_id, "s": self.span_id,
                "b": dict(self.baggage)}

    @classmethod
    def from_wire(cls, wire: Optional[Dict[str, Any]]
                  ) -> Optional["TraceContext"]:
        if not wire:
            return None
        return cls(trace_id=wire["t"], span_id=wire["s"],
                   parent_span_id=None,
                   baggage=dict(wire.get("b") or {}))


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("ray_tpu_torch_trace_context", default=None)


def current_trace() -> Optional[TraceContext]:
    """The TraceContext active on this thread/coroutine, or None."""
    return _CURRENT.get()


def child_context() -> Optional[TraceContext]:
    """A fresh context parented under the active span (same trace, new
    span_id, baggage copied), or None when no trace is active."""
    tc = _CURRENT.get()
    if tc is None:
        return None
    return TraceContext(trace_id=tc.trace_id, span_id=new_span_id(),
                        parent_span_id=tc.span_id,
                        baggage=dict(tc.baggage))


def current_wire_context() -> Optional[Dict[str, Any]]:
    """``current_trace().to_wire()`` or None — what ``.remote()`` stamps
    onto the TaskSpec."""
    tc = _CURRENT.get()
    return tc.to_wire() if tc is not None else None


def activate_wire_context(wire: Optional[Dict[str, Any]]
                          ) -> Optional[contextvars.Token]:
    """Executing-worker side: restore the caller's context around a task
    body. Returns a token for ``deactivate_context`` (None when there
    was nothing to restore — pass it back unconditionally)."""
    tc = TraceContext.from_wire(wire)
    if tc is None:
        return None
    return _CURRENT.set(tc)


def deactivate_context(token: Optional[contextvars.Token]) -> None:
    if token is not None:
        _CURRENT.reset(token)


@contextmanager
def trace_root(name: str, attrs: Optional[Dict[str, Any]] = None,
               baggage: Optional[Dict[str, Any]] = None
               ) -> Iterator[TraceContext]:
    """Open a new trace: fresh trace_id, root span active for the block.
    The recorded root span is tagged ``attrs["trace_root"]`` — the
    signal the GCS TraceStore completes (and tail-samples) a trace on."""
    tc = TraceContext(trace_id=new_trace_id(), span_id=new_span_id(),
                      parent_span_id=None, baggage=dict(baggage or {}))
    token = _CURRENT.set(tc)
    start = time.time()
    attrs = dict(attrs) if attrs else {}
    attrs["trace_root"] = True
    try:
        yield tc
    except BaseException as e:
        attrs["error"] = type(e).__name__
        raise
    finally:
        _CURRENT.reset(token)
        record_span(name, start, time.time() - start, attrs,
                    trace={"trace_id": tc.trace_id,
                           "span_id": tc.span_id,
                           "parent_span_id": None})


def record_span(name: str, start: float, dur: float,
                attrs: Optional[Dict[str, Any]] = None, *,
                trace: Optional[Dict[str, Any]] = None) -> None:
    """Record a span with explicit wall-clock start/duration — for
    callers that reconstruct lifecycle phases after the fact (the LLM
    engine's queued/prefill/decode phases).

    Trace fields are stamped exactly once: an explicit ``trace`` dict
    (``trace_id``/``span_id``/``parent_span_id``) wins outright;
    otherwise the ambient context, if any, contributes the trace_id and
    parents a *fresh* span id under the active span. ``span()`` and
    ``trace_root()`` always pass ``trace=`` explicitly, so a span is
    never double-tagged by its own ambient push."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is not None and (getattr(w, "_dead", False)
                          or not hasattr(w, "_task_events_lock")):
        return
    tid = w.current_task_id() if w is not None else None
    event = {
        "task_id": tid.binary() if tid else SPAN_TASK_ID,
        "name": name, "job_id": b"", "state": "SPAN",
        "ts": start, "dur": dur,
        "owner_pid": os.getpid(),
        "attrs": attrs or {},
    }
    if trace is None:
        tc = _CURRENT.get()
        if tc is not None:
            trace = {"trace_id": tc.trace_id,
                     "span_id": new_span_id(),
                     "parent_span_id": tc.span_id}
    if trace is not None and trace.get("trace_id"):
        event["trace_id"] = trace["trace_id"]
        event["span_id"] = trace.get("span_id")
        event["parent_span_id"] = trace.get("parent_span_id")
    if w is None:
        with _span_lock:
            _spans.append(event)
        return
    with w._task_events_lock:
        w._task_events.append(event)
    if event.get("trace_id"):
        # Traced spans feed the GCS TraceStore; nudge the debounced
        # flush so traces assemble on a sub-second cadence instead of
        # waiting for the 100-event batch threshold.
        flush = getattr(w, "flush_task_events_soon", None)
        if flush is not None:
            flush()


def span_events(trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """The buffered SPAN events, oldest first (those of one trace when
    ``trace_id`` is given). The buffer keeps them."""
    with _span_lock:
        events = list(_spans)
    if trace_id is not None:
        events = [e for e in events if e.get("trace_id") == trace_id]
    return events


def drain_span_events() -> List[Dict[str, Any]]:
    """Take every buffered SPAN event out of the buffer, oldest first."""
    with _span_lock:
        events = list(_spans)
        _spans.clear()
    return events


@contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None) -> Iterator[None]:
    """Record a named span around a block. When a trace
    is active, the block runs under a child context (so nested spans and
    ``.remote()`` calls parent here) and the recorded SPAN event carries
    the trace fields. A raising body still records the span, tagged
    ``attrs["error"]`` with the exception type so timelines distinguish
    failures from successes."""
    child = child_context()
    token = _CURRENT.set(child) if child is not None else None
    start = time.time()
    attrs = dict(attrs) if attrs else {}
    try:
        yield
    except BaseException as e:
        attrs["error"] = type(e).__name__
        raise
    finally:
        if token is not None:
            _CURRENT.reset(token)
        record_span(name, start, time.time() - start, attrs,
                    trace=({"trace_id": child.trace_id,
                            "span_id": child.span_id,
                            "parent_span_id": child.parent_span_id}
                           if child is not None else {}))


# ----------------------------------------------------- tree / analysis


def build_trace_tree(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Assemble normalized span dicts (trace_id/span_id/parent_span_id/
    name/ts/dur/attrs) into one causal tree. Never drops anything:
    spans whose parent did not arrive (a crashed or late hop) surface
    in ``orphans``; extra parentless spans beyond the root do too."""
    nodes: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid is None or sid in nodes:
            continue
        nodes[sid] = {
            "span_id": sid,
            "parent_span_id": s.get("parent_span_id"),
            "name": s.get("name"),
            "ts": s.get("ts"), "dur": s.get("dur", 0.0),
            "attrs": dict(s.get("attrs") or {}),
            "children": [],
        }
    rootless: List[Dict[str, Any]] = []
    orphans: List[Dict[str, Any]] = []
    for node in nodes.values():
        parent = node["parent_span_id"]
        if parent is None:
            rootless.append(node)
        elif parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            orphans.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda c: c["ts"] or 0.0)
    rootless.sort(key=lambda n: n["ts"] or 0.0)
    root = next((n for n in rootless if n["attrs"].get("trace_root")),
                rootless[0] if rootless else None)
    orphans.extend(n for n in rootless if n is not root)
    return {"num_spans": len(spans), "root": root, "orphans": orphans}


def critical_path(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Walk the tree root-down, always descending into the
    longest-duration child: the hops a request's latency actually
    flowed through. Each hop's ``self_s`` is its duration minus its
    children's (time spent *in* that hop, not waiting below it); the
    ``dominant`` hop is where the request's time went."""
    root = tree.get("root") if "root" in tree else tree
    if not root:
        return {"path": [], "dominant": None,
                "dominant_self_s": 0.0, "total_s": 0.0}
    path = []
    node = root
    while node is not None:
        kids = node.get("children") or []
        dur = node.get("dur") or 0.0
        self_s = max(0.0, dur - sum(c.get("dur") or 0.0 for c in kids))
        path.append({"name": node.get("name"),
                     "span_id": node.get("span_id"),
                     "dur": dur, "self_s": self_s})
        node = (max(kids, key=lambda c: c.get("dur") or 0.0)
                if kids else None)
    dominant = max(path, key=lambda h: h["self_s"])
    return {"path": path, "dominant": dominant["name"],
            "dominant_self_s": dominant["self_s"],
            "total_s": root.get("dur") or 0.0}


def span_tree(events: Optional[List[Dict[str, Any]]] = None
              ) -> List[Dict[str, Any]]:
    """The reference's cross-task call tree, built from ``events`` (task
    lifecycle and SPAN events; default: the head's task-event ring with
    a worker attached, else the span buffer). Each node is a task with
    its lifecycle timestamps, user spans, and children (tasks it
    submitted). SPAN events whose task node has no lifecycle event are
    surfaced under a synthetic ``(orphaned-spans)`` root, never dropped:
    with only the span buffer, that is where every span lands."""
    if events is None:
        from ray_tpu_torch._private.worker import global_worker_or_none

        if global_worker_or_none() is not None:
            import ray_tpu_torch

            events = ray_tpu_torch.task_events()
        else:
            events = span_events()
    nodes: Dict[bytes, Dict[str, Any]] = {}
    spans: Dict[bytes, List[Dict[str, Any]]] = {}
    for e in events:
        if e["state"] == "SPAN":
            spans.setdefault(e["task_id"], []).append(
                {"name": e["name"], "ts": e["ts"], "dur": e.get("dur", 0),
                 "attrs": e.get("attrs", {})})
            continue
        node = nodes.setdefault(e["task_id"], {
            "task_id": e["task_id"].hex(), "name": e["name"],
            "states": {}, "children": [], "spans": [],
            "parent_task_id": None})
        node["states"][e["state"]] = e["ts"]
        if e.get("parent_task_id"):
            node["parent_task_id"] = e["parent_task_id"]
    lost: List[Dict[str, Any]] = []
    for tid, sp in spans.items():
        if tid in nodes:
            nodes[tid]["spans"] = sorted(sp, key=lambda s: s["ts"])
        else:
            for s in sp:
                s = dict(s)
                s["attrs"] = dict(s["attrs"]) | {"orphan": True}
                lost.append(s)
    roots = []
    for node in nodes.values():
        parent = node.pop("parent_task_id", None)
        pnode = nodes.get(parent) if parent else None
        if pnode is not None and pnode is not node:
            pnode["children"].append(node)
        else:
            roots.append(node)
    if lost:
        roots.append({"task_id": None, "name": "(orphaned-spans)",
                      "orphan": True, "states": {}, "children": [],
                      "spans": sorted(lost, key=lambda s: s["ts"])})
    return roots
