"""State API SDK — programmatic cluster introspection: the port's copy of
``ray_tpu/util/state.py`` (reference: `python/ray/util/state/api.py`,
``ray.util.state.list_actors`` etc. over the GCS + per-raylet state
RPCs, `node_manager.proto:420-422`).

Every view is the reference's, over the same GCS and raylet handlers:
actors, workers, nodes, jobs, tasks, placement groups, objects and
memory, resources, the summaries, cluster events, the train step
matrix, the serve accounting ring, the trace store, and the host-side
forensics (``get_log``, ``stack`` and ``profile``: a log read, a Python
stack dump and a wall-clock sampler). Three raise
``NotImplementedError`` naming the slice that brings them:
``xla_summary`` and ``list_xla_programs`` (the GCS's compiled-program
ring) and ``tpu_profile`` (the worker's device-profile bracket), both
with the device-facing observability slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import ray_tpu_torch


def _gcs():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs


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


def list_jobs() -> List[Dict[str, Any]]:
    return [{
        "job_id": j["job_id"].hex(),
        "state": j.get("state"),
        "metadata": j.get("metadata") or {},
    } for j in _gcs().call("list_jobs", timeout=30)]


def list_placement_groups() -> List[Dict[str, Any]]:
    return [{
        "placement_group_id": p["pg_id"].hex(),
        "state": p.get("state"),
        "strategy": p.get("strategy"),
        "bundles": p.get("bundles"),
        "name": p.get("name", ""),
    } for p in _gcs().call("list_placement_groups", timeout=30)]


def list_tasks(job_id: Optional[bytes] = None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    """Latest lifecycle state per task from the GCS task-event table."""
    events = _gcs().call("get_task_events", job_id=job_id, limit=limit * 4,
                         timeout=30)
    latest: Dict[bytes, Dict[str, Any]] = {}
    for e in events:
        latest[e["task_id"]] = e
    out = []
    for e in list(latest.values())[-limit:]:
        out.append({
            "task_id": e["task_id"].hex(),
            "name": e.get("name"),
            "state": e.get("state"),
            "job_id": e["job_id"].hex() if e.get("job_id") else None,
            "ts": e.get("ts"),
        })
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Per-node shared-memory store summaries (via raylet node_stats)."""
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    out = []
    for node in _gcs().call("get_all_nodes", timeout=30):
        if node.get("state") != "ALIVE":
            continue
        client = w._raylet_for_node(node["node_id"])
        if client is None:
            continue
        try:
            stats = client.call("node_stats", timeout=15)
        except Exception:
            continue
        row = dict(stats.get("store") or {})
        row["node_id"] = node["node_id"].hex()
        row["num_workers"] = stats.get("num_workers")
        out.append(row)
    return out


def memory_summary(top_n: int = 10) -> Dict[str, Any]:
    """Cluster object-store memory introspection (reference: `ray memory`
    / `ray_private.internal_api.memory_summary`).

    Returns::

        {"nodes":   [per-node store stats: used/capacity/num_objects/
                     pinned_bytes/spilled_bytes, spill/restore/eviction
                     counters + cumulative spill/restore wall time],
         "totals":  the same counters summed across nodes,
         "top_objects": top-N objects cluster-wide by size, each with
                     node, size, sealed/pinned/spilled state, idle age,
                     and this driver's reference-count view (owned /
                     borrowed / untracked),
         "hints":   reference-leak heuristics — pinned primaries this
                     driver no longer tracks, long-idle pinned objects}
    """
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    nodes: List[Dict[str, Any]] = []
    objects: List[Dict[str, Any]] = []
    for node in _gcs().call("get_all_nodes", timeout=30):
        if node.get("state") != "ALIVE":
            continue
        client = w._raylet_for_node(node["node_id"])
        if client is None:
            continue
        try:
            stats = client.call("memory_stats", top_n=max(top_n, 0),
                                timeout=15)
        except Exception:
            continue
        node_hex = node["node_id"].hex()
        row = dict(stats.get("store") or {})
        row["node_id"] = node_hex
        nodes.append(row)
        for obj in stats.get("objects") or []:
            obj = dict(obj)
            obj["node_id"] = node_hex
            objects.append(obj)

    totals: Dict[str, float] = {}
    for row in nodes:
        for k, v in row.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[k] = totals.get(k, 0) + v

    objects.sort(key=lambda o: o.get("size", 0), reverse=True)
    top = objects[:top_n] if top_n else objects
    hints: List[str] = []
    for obj in top:
        try:
            oid = bytes.fromhex(obj["object_id"])
        except (KeyError, ValueError):
            oid = None
        snap = w.reference_counter.snapshot(oid) if oid is not None else None
        if snap is None:
            obj["reference"] = "untracked"
        elif snap["freed"]:
            obj["reference"] = "freed"
        else:
            obj["reference"] = ("owned" if snap["is_owned_by_us"]
                                else "borrowed")
        if obj.get("pinned") and obj["reference"] == "untracked":
            hints.append(
                f"object {obj['object_id'][:12]} ({obj['size']} B, node "
                f"{obj['node_id'][:12]}) is pinned but this driver holds "
                f"no reference — possible leaked primary (owner exited "
                f"without cleanup?)")
        elif obj.get("pinned") and obj.get("idle_s", 0) > 600:
            hints.append(
                f"object {obj['object_id'][:12]} ({obj['size']} B) pinned "
                f"and idle {obj['idle_s']:.0f}s — check for a retained "
                f"ObjectRef that is no longer needed")
    return {"nodes": nodes, "totals": totals, "top_objects": top,
            "hints": hints,
            "num_tracked_refs": w.reference_counter.num_tracked()}


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


def summary() -> Dict[str, Any]:
    nodes = ray_tpu_torch.nodes()
    return {
        "nodes_alive": sum(1 for n in nodes if n["Alive"]),
        "nodes_dead": sum(1 for n in nodes if not n["Alive"]),
        "actors": len(list_actors()),
        "workers": len(list_workers()),
        "cluster_resources": cluster_resources(),
        "available_resources": available_resources(),
    }


def summary_tasks() -> List[Dict[str, Any]]:
    """Per-function-name rollup of task lifecycle states (reference:
    `ray summary tasks` / `util/state/summary.py`)."""
    from collections import defaultdict

    agg: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for e in ray_tpu_torch.task_events():
        if e.get("state") == "SPAN":
            continue
        agg[e["name"]][e["state"]] += 1
    out = []
    for name, states in sorted(agg.items()):
        # PENDING/RUNNING counts are event totals; net in-flight =
        # submitted minus finished/failed.
        out.append({"name": name, **dict(states),
                    "total": states.get("PENDING", 0)})
    return out


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
    filtered by worker label (e.g. ``train-0``, ``learner-1``)."""
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


def get_log(task_id: Optional[str] = None, actor_id: Optional[str] = None,
            worker_id: Optional[str] = None,
            tail: int = 100) -> List[str]:
    """Retrieve log lines for one task, actor, or worker (reference:
    `ray.util.state.get_log`). Exactly one selector is required; IDs are
    hex strings (as returned by the list_* APIs / ``ref.task_id().hex()``).
    Task logs are sliced out of the owning worker's log file via the
    per-task attribution markers, so a pooled worker that ran many tasks
    returns only the requested task's lines. Served by the raylet from
    the on-disk log files, so logs of dead workers remain retrievable."""
    from ray_tpu_torch._private.worker import global_worker

    selectors = [s for s in (task_id, actor_id, worker_id) if s]
    if len(selectors) != 1:
        raise ValueError(
            "get_log requires exactly one of task_id=, actor_id=, "
            "worker_id=")
    w = global_worker()
    gcs = _gcs()
    if actor_id is not None:
        # Resolve the actor to its current worker; the worker branch
        # below then finds the node.
        info = gcs.call("get_actor_info",
                        actor_id=bytes.fromhex(actor_id), timeout=30)
        if not info or not info.get("worker_id"):
            raise ValueError(f"actor {actor_id} not found or has no "
                             "worker")
        worker_id = info["worker_id"].hex()
    if worker_id is not None:
        node_hex = None
        for row in gcs.call("list_workers", timeout=30):
            if row["worker_id"].hex() == worker_id:
                node_hex = row["node_id"].hex()
                break
        if node_hex is None:
            raise ValueError(f"worker {worker_id} not found")
        client = w._raylet_for_node(bytes.fromhex(node_hex))
        if client is None:
            raise ValueError(f"node {node_hex[:12]} hosting worker "
                             f"{worker_id[:12]} is unreachable")
        reply = client.call("get_log",
                            worker_id=bytes.fromhex(worker_id),
                            tail=tail, timeout=30)
        return reply.get("lines", [])
    # task_id: the owning worker isn't tracked after the fact — fan out
    # to every alive node; the markers make non-owners return nothing.
    lines: List[str] = []
    for node in gcs.call("get_all_nodes", timeout=30):
        if node.get("state") != "ALIVE":
            continue
        client = w._raylet_for_node(node["node_id"])
        if client is None:
            continue
        try:
            reply = client.call("get_log", task_id=task_id, tail=tail,
                                timeout=30)
        except Exception:
            continue
        lines.extend(reply.get("lines", []))
    if tail:
        lines = lines[-int(tail):]
    return lines


def _resolve_actor_worker(actor_id: str) -> str:
    """actor id hex -> its current worker id hex (via the GCS actor
    table); raises ValueError for unknown/worker-less actors."""
    info = _gcs().call("get_actor_info",
                       actor_id=bytes.fromhex(actor_id), timeout=30)
    if not info or not info.get("worker_id"):
        raise ValueError(f"actor {actor_id} not found or has no worker")
    return info["worker_id"].hex()


def _worker_row(worker_id: str) -> Dict[str, Any]:
    """GCS registration row (node_id, addr, pid) for one worker id hex."""
    for row in _gcs().call("list_workers", timeout=30):
        if row["worker_id"].hex() == worker_id:
            return row
    raise ValueError(f"worker {worker_id} not found")


def stack(node_id: Optional[str] = None, worker_id: Optional[str] = None,
          actor_id: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Live all-thread Python stacks across the cluster (the `ray stack`
    equivalent). Selectors narrow the fan-out: ``actor_id`` -> that
    actor's worker, ``worker_id`` -> that worker, ``node_id`` (hex
    prefix) -> every worker on that node; with none, every worker on
    every alive node. Returns ``{worker_id_hex: {"pid", "threads":
    [{"thread_name", "stack", ...}], "stacks": text}}`` — unreachable
    workers report ``{"error": ...}`` instead of failing the sweep."""
    from ray_tpu_torch._private.worker import global_worker

    if sum(bool(s) for s in (node_id, worker_id, actor_id)) > 1:
        raise ValueError("stack() takes at most one of node_id=, "
                         "worker_id=, actor_id=")
    w = global_worker()
    gcs = _gcs()
    if actor_id is not None:
        worker_id = _resolve_actor_worker(actor_id)
    target_worker = bytes.fromhex(worker_id) if worker_id else None
    if worker_id is not None:
        node_id = _worker_row(worker_id)["node_id"].hex()
    out: Dict[str, Dict[str, Any]] = {}
    for node in gcs.call("get_all_nodes", timeout=30):
        if node.get("state") != "ALIVE":
            continue
        if node_id and not node["node_id"].hex().startswith(node_id):
            continue
        client = w._raylet_for_node(node["node_id"])
        if client is None:
            continue
        try:
            out.update(client.call("dump_stacks", worker_id=target_worker,
                                   timeout=30) or {})
        except Exception as e:  # noqa: BLE001
            out[f"node-{node['node_id'].hex()[:12]}"] = {"error": repr(e)}
    return out


def profile(actor_id: Optional[str] = None,
            worker_id: Optional[str] = None,
            duration: float = 1.0,
            hz: Optional[float] = None) -> Dict[str, Any]:
    """Wall-clock flamegraph of one actor's (or worker's) process:
    samples every thread at ``hz`` for ``duration`` seconds and merges
    them into a collapsed-stack (``folded``) + speedscope
    (``speedscope``) payload with per-thread attribution.

    The window is chunked into short worker-side RPCs, so a target that
    dies mid-profile yields the samples gathered so far instead of a
    hang: the reply is tagged ``partial=True`` with the raylet's PR-4
    exit classification under ``exit`` (exit_type / detail) explaining
    *why* the profile came back short."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.observability import profiling as _profiling

    if sum(bool(s) for s in (worker_id, actor_id)) != 1:
        raise ValueError("profile() requires exactly one of actor_id=, "
                         "worker_id=")
    if actor_id is not None:
        worker_id = _resolve_actor_worker(actor_id)
    row = _worker_row(worker_id)
    w = global_worker()
    client = w._client_for(tuple(row["addr"]))
    counts: Dict[str, Dict[str, int]] = {}
    samples = dropped = 0
    sampled_s = 0.0
    partial = False
    exit_info: Optional[Dict[str, Any]] = None
    remaining = max(float(duration), 0.05)
    chunk = min(0.5, remaining)
    while remaining > 1e-3:
        win = min(chunk, remaining)
        try:
            reply = client.call("profile", duration_s=win, hz=hz,
                                timeout=win + 15)
        except Exception:  # noqa: BLE001 — died mid-window
            partial = True
            exit_info = _classify_worker_exit(w, row, worker_id)
            break
        _profiling.merge_counts(counts, reply.get("counts") or {})
        samples += reply.get("samples", 0)
        dropped += reply.get("dropped", 0)
        sampled_s += reply.get("duration_s", win)
        hz = reply.get("hz", hz)
        remaining -= win
    label = f"{'actor ' + actor_id if actor_id else 'worker ' + worker_id}"
    return {
        "worker_id": worker_id, "pid": row.get("pid"),
        "duration_s": sampled_s, "hz": hz,
        "samples": samples, "dropped": dropped,
        "folded": _profiling.collapse(counts),
        "speedscope": _profiling.render_speedscope(
            counts, name=f"ray_tpu_torch profile: {label}"),
        "partial": partial, "exit": exit_info,
    }


def _classify_worker_exit(w, row: Dict[str, Any],
                          worker_id: str) -> Dict[str, Any]:
    """Why did the profile target go away mid-window? Ask its lessor
    raylet for the PR-4 exit classification (one short retry — the
    reaper polls every 200ms, the profiler often notices first)."""
    from ray_tpu_torch.observability import events as _events

    info: Dict[str, Any] = {}
    client = w._raylet_for_node(row["node_id"])
    if client is not None:
        for attempt in range(2):
            try:
                info = client.call(
                    "get_worker_exit_info",
                    worker_id=bytes.fromhex(worker_id), timeout=5) or {}
            except Exception:  # noqa: BLE001
                info = {}
            if info.get("exit_type"):
                break
            if attempt == 0:
                import time as _time

                _time.sleep(0.5)
    else:
        info = {"exit_type": "NODE_DEATH"}
    out = dict(info)
    out.setdefault("exit_type", "SYSTEM_ERROR")
    try:
        out["detail"] = _events.format_exit_detail(info, None)
    except Exception:  # noqa: BLE001
        out["detail"] = ""
    return out


def summary_actors() -> List[Dict[str, Any]]:
    """Per-class rollup of actor states (reference: `ray summary
    actors`)."""
    from collections import defaultdict

    agg: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for a in list_actors():
        cls = a.get("class_name") or a.get("name") or "<anonymous>"
        agg[cls][a.get("state", "UNKNOWN")] += 1
    return [{"class": cls, **dict(states)}
            for cls, states in sorted(agg.items())]


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


def xla_summary(top_n: int = 8) -> Dict[str, Any]:
    """The fleet's program cost rollup from the GCS program ring: the
    current program set (one row per tracked function x argument
    signature x process) ranked by cumulative FLOPs, peak device bytes,
    and lost-to-roofline headroom seconds, plus roofline-verdict and
    measurement counts. Answers "which program is eating the fleet, and
    is it compute-, memory-, or comm-bound?". The name is the
    reference's; rows whose ``measurement`` is ``"gpu"`` measure the
    CUDA program on the card, ``"cpu"`` rows carry nominal-spec ratios
    that prove the plumbing, not performance."""
    return _gcs().call("xla_summary", top_n=top_n, timeout=30)


def list_xla_programs(fn: Optional[str] = None,
                      verdict: Optional[str] = None,
                      limit: int = 200) -> List[Dict[str, Any]]:
    """Newest-last program cost rows from the GCS program ring (fn,
    signature, flops, bytes accessed, device-memory breakdown, sampled
    wall, MFU/MBU, roofline verdict), optionally filtered by function
    name or verdict (``compute-bound`` / ``memory-bound`` /
    ``comm-bound`` / ``unsampled`` / ``unknown``)."""
    return _gcs().call("list_xla_programs", fn=fn, verdict=verdict,
                       limit=limit, timeout=30)


def tpu_profile(actor_id: Optional[str] = None,
                worker_id: Optional[str] = None,
                duration: float = 1.0) -> Dict[str, Any]:
    """Capture a device trace (torch.profiler, CPU and CUDA activities)
    on the target worker for ``duration`` seconds and return
    ``{"artifact": path, "kernel_events": n, ...}``: a Chrome trace JSON
    on the worker's host (chrome://tracing, Perfetto). The name is the
    reference's; on the card it traces the CUDA device. A worker without
    a CUDA context gives ``{"skipped": reason}`` (host flamegraphs,
    :func:`profile`, still work there), and one whose bracket is already
    open ``{"error": reason}``."""
    from ray_tpu_torch._private.worker import global_worker

    if sum(bool(s) for s in (worker_id, actor_id)) != 1:
        raise ValueError("tpu_profile() requires exactly one of actor_id=, "
                         "worker_id=")
    if actor_id is not None:
        worker_id = _resolve_actor_worker(actor_id)
    row = _worker_row(worker_id)
    w = global_worker()
    client = w._client_for(tuple(row["addr"]))
    return client.call("tpu_profile", duration_s=float(duration),
                       timeout=float(duration) + 60)
