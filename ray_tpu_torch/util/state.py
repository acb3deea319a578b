"""State API SDK — programmatic cluster introspection: the port's copy of
``ray_tpu/util/state.py`` (reference: `python/ray/util/state/api.py`,
``ray.util.state.list_actors`` etc. over the GCS + per-raylet state
RPCs, `node_manager.proto:420-422`).

The functions whose GCS handler the port has are the reference's:
actors, workers, nodes, resources, cluster events, the train step
matrix, the serve accounting ring and the trace store. The rest raise
``NotImplementedError`` naming the slice that brings them (the per-node
object and memory views and the task, job and placement-group listings
with the state slice, logs, stacks and profiles with the device-facing
observability).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import ray_tpu_torch


def _gcs():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs


def _not_ported(name: str, where: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"util.state.{name} is not ported yet: it comes with {where}")

    missing.__name__ = name
    return missing


def list_nodes() -> List[Dict[str, Any]]:
    return ray_tpu_torch.nodes()


def list_actors(detail: bool = False) -> List[Dict[str, Any]]:
    out = []
    for info in _gcs().call("list_actors", timeout=30):
        row = {
            "actor_id": info["actor_id"].hex(),
            "class_name": info.get("class_name", ""),
            "state": info.get("state"),
            "name": info.get("name", ""),
            "node_id": (info.get("node_id") or b"").hex(),
            "worker_id": (info.get("worker_id") or b"").hex(),
        }
        if detail:
            row["death_cause"] = info.get("death_cause")
            row["num_restarts"] = info.get("restarts_used", 0)
        out.append(row)
    return out


def list_workers() -> List[Dict[str, Any]]:
    return [{
        "worker_id": w["worker_id"].hex(),
        "node_id": w["node_id"].hex(),
        "mode": w.get("mode"),
        "pid": w.get("pid"),
    } for w in _gcs().call("list_workers", timeout=30)]


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for node in _gcs().call("get_all_nodes", timeout=30):
        if node.get("state") != "ALIVE":
            continue
        for k, v in (node.get("total") or {}).items():
            total[k] = total.get(k, 0) + v
    return total


def available_resources() -> Dict[str, float]:
    avail: Dict[str, float] = {}
    for node in _gcs().call("get_all_nodes", timeout=30):
        if node.get("state") != "ALIVE":
            continue
        for k, v in (node.get("available") or {}).items():
            avail[k] = avail.get(k, 0) + v
    return avail


def list_cluster_events(event_type: Optional[str] = None,
                        severity: Optional[str] = None,
                        node_id: Optional[str] = None,
                        limit: int = 100) -> List[Dict[str, Any]]:
    """Typed failure-forensics events from the GCS ClusterEventLog
    (reference: `ray list cluster-events` / gcs event export). Filters:
    ``event_type`` (see ray_tpu_torch.observability.EVENT_TYPES), ``severity``
    (INFO/WARNING/ERROR), ``node_id`` hex prefix."""
    return _gcs().call("list_cluster_events", event_type=event_type,
                       severity=severity, node_id=node_id, limit=limit,
                       timeout=30)


def summary_events() -> Dict[str, Any]:
    """Rollup of the ClusterEventLog: total recorded, currently
    buffered, and a type -> severity -> count table."""
    return _gcs().call("summary_cluster_events", timeout=30)


def train_summary() -> Dict[str, Any]:
    """The training goodput & straggler rollup from the GCS step
    matrix: per-worker step counts / mean step wall / stall and
    straggler flags, the cluster goodput ratio (productive seconds
    over accounted wall), lost seconds by cause
    (stalled/recompiling/restarting/checkpointing), per-phase mean
    seconds, and the recent TRAIN_STRAGGLER flags. Answers "which
    worker is slowing the pod, and in which phase?" without logs."""
    return _gcs().call("train_summary", timeout=30)


def list_train_steps(worker: Optional[str] = None,
                     limit: int = 200) -> List[Dict[str, Any]]:
    """Newest-last rows of the cross-worker train step matrix (worker,
    step, wall_s, per-phase seconds, goodput snapshot), optionally
    filtered by worker label (e.g. ``train-0``, ``rank1``)."""
    return _gcs().call("list_train_steps", worker=worker, limit=limit,
                       timeout=30)


def serve_accounting(top_n: Optional[int] = None,
                     trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The serve cost-accounting rollup from the GCS accounting ring:
    top-N tenants by chip-seconds (tokens, KV block-seconds, prefill
    computed/avoided per tenant — "which tenant is eating the
    fleet?"), per-lane SLO attainment and burn rates (fast/slow
    windows), and ring occupancy. Pass the ``x-trace-id`` a routed
    request returned as ``trace_id`` to also get that request's own
    cost row under ``"request"``."""
    return _gcs().call("serve_accounting_summary", top_n=top_n,
                       trace_id=trace_id, timeout=30)


def list_serve_accounting(tenant: Optional[str] = None,
                          lane: Optional[str] = None,
                          trace_id: Optional[str] = None,
                          limit: int = 200) -> List[Dict[str, Any]]:
    """Newest-last per-request cost rows from the GCS accounting ring
    (tenant, lane, trace_id, tokens, block-seconds, chip-seconds per
    phase, speculative counts, TTFT/TPOT), optionally filtered."""
    return _gcs().call("list_serve_accounting", tenant=tenant,
                       lane=lane, trace_id=trace_id, limit=limit,
                       timeout=30)


# ------------------------------------------------------------------- traces


def get_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """One request's causal tree from the GCS trace store, or None.
    Returns the assembled tree (``root``/``orphans``/``num_spans`` from
    ``tracing.build_trace_tree``) plus the store's verdict: ``complete``
    (the root span arrived and tail-sampling kept it), ``dur`` (root
    duration), ``error`` and ``keep_reason``. An in-flight trace comes
    back partial with ``complete`` False — debugging never waits on
    sampling."""
    from ray_tpu_torch.util.tracing import build_trace_tree

    rec = _gcs().call("get_trace", trace_id=trace_id, timeout=30)
    if rec is None:
        return None
    tree = build_trace_tree(rec.get("spans") or [])
    tree.update({
        "trace_id": trace_id,
        "complete": bool(rec.get("complete")),
        "dur": rec.get("dur"),
        "error": rec.get("error", False),
        "keep_reason": rec.get("keep_reason"),
    })
    return tree


def list_traces(limit: int = 100) -> List[Dict[str, Any]]:
    """Summaries of kept traces, newest first (trace_id, root_name, ts,
    dur, error, keep_reason, num_spans)."""
    return _gcs().call("list_traces", limit=limit, timeout=30)


def trace_critical_path(tree_or_id: Any) -> Dict[str, Any]:
    """Critical path of a trace: pass either a tree from
    :func:`get_trace` or a bare trace_id string. Answers "where did
    this request's time go" — the dominant hop is the one with the most
    self-time along the longest-duration root-to-leaf walk."""
    from ray_tpu_torch.util.tracing import critical_path

    tree = tree_or_id
    if isinstance(tree_or_id, str):
        tree = get_trace(tree_or_id)
        if tree is None:
            raise ValueError(f"no trace {tree_or_id!r} in the store")
    return critical_path(tree)


# Not ported yet: each raises, naming the slice that brings it.
_STATE = "the state slice (jobs, tasks, placement groups, objects)"
_DEVICE = ("the device-facing observability slice (the program ring, "
           "the workers' logs, stacks and device-profile bracket)")

list_jobs = _not_ported("list_jobs", _STATE)
list_placement_groups = _not_ported("list_placement_groups", _STATE)
list_tasks = _not_ported("list_tasks", _STATE)
list_objects = _not_ported("list_objects", _STATE)
memory_summary = _not_ported("memory_summary", _STATE)
summary = _not_ported("summary", _STATE)
summary_tasks = _not_ported("summary_tasks", _STATE)
summary_actors = _not_ported("summary_actors", _STATE)
xla_summary = _not_ported("xla_summary", _DEVICE)
list_xla_programs = _not_ported("list_xla_programs", _DEVICE)
get_log = _not_ported("get_log", _DEVICE)
stack = _not_ported("stack", _DEVICE)
profile = _not_ported("profile", _DEVICE)
tpu_profile = _not_ported("tpu_profile", _DEVICE)
