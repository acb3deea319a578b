"""GCS — the head-node control plane.

Role-equivalent to the reference's `src/ray/gcs/gcs_server/gcs_server.cc:187-232`
which installs node / resource / health / job / actor / placement-group / KV /
pubsub / task-event managers. One GCS per cluster, run as its own process
(``python -m ray_tpu_torch._private.gcs_server``). State lives in an in-memory store
(the reference's default `gcs_storage="memory"`), with a periodic
file-backed snapshot of the durable tables (KV, jobs, named-actor registry)
so a restarted GCS recovers them (reference analog:
`store_client/redis_store_client.h:33` — Redis-backed FT).

Actors are scheduled *centrally* here (reference: `gcs_actor_scheduler.cc:49`),
unlike normal tasks which use the distributed raylet lease protocol.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ActorID, NodeID, PlacementGroupID
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.rpc import RpcClient, RpcServer, get_io_loop, spawn_task
from ray_tpu_torch._private.scheduling_policy import ClusterView, pick_node
from ray_tpu_torch._private.task_spec import SchedulingStrategySpec

ALIVE = "ALIVE"
DEAD = "DEAD"

# Actor lifecycle states (reference: src/ray/design_docs/actor_states.rst)
PENDING_CREATION = "PENDING_CREATION"
RESTARTING = "RESTARTING"


class Pubsub:
    """Long-poll pub/sub (reference: `src/ray/pubsub/`)."""

    def __init__(self):
        self._channels: Dict[str, List[Tuple[int, Any]]] = defaultdict(list)
        self._events: Dict[str, asyncio.Event] = defaultdict(asyncio.Event)
        self._seq = 0
        self.on_publish = None   # hook: snapshot dirty-marking

    def publish(self, channel: str, message: Any) -> None:
        if self.on_publish is not None:
            self.on_publish(channel)
        self._seq += 1
        log = self._channels[channel]
        log.append((self._seq, message))
        if len(log) > 10000:
            del log[: len(log) - 10000]
        ev = self._events[channel]
        ev.set()
        self._events[channel] = asyncio.Event()

    async def poll(self, channel: str, cursor: int, timeout: float):
        deadline = time.monotonic() + timeout
        while True:
            msgs = [(s, m) for s, m in self._channels[channel] if s > cursor]
            if msgs:
                return msgs
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._events[channel].wait()), remaining)
            except asyncio.TimeoutError:
                return []


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.server = RpcServer(host, port)
        self.view = ClusterView()
        # Bumped whenever the nodes snapshot would change (membership or a
        # node's resource availability). Raylets echo the last seq they
        # applied; heartbeat replies carry a fresh snapshot only when it
        # advanced — at a 100ms report period an idle cluster would
        # otherwise serialize O(nodes) snapshots to every raylet 10x/s.
        self._view_seq = 1
        self.pubsub = Pubsub()

        # node_id(bytes) -> node info dict
        self.nodes: Dict[bytes, Dict[str, Any]] = {}
        self._node_clients: Dict[bytes, RpcClient] = {}
        self._last_heartbeat: Dict[bytes, float] = {}

        # actors
        self.actors: Dict[bytes, Dict[str, Any]] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}
        self._actor_events: Dict[bytes, asyncio.Event] = {}
        # actor_id -> the demand of an actor that no node can take now:
        # the autoscaler's signal, as a raylet's infeasible task lease is.
        self._actor_demands: Dict[bytes, Dict[str, float]] = {}

        # kv: namespace -> key -> bytes
        self.kv: Dict[str, Dict[str, bytes]] = defaultdict(dict)

        # placement groups
        self.placement_groups: Dict[bytes, Dict[str, Any]] = {}

        # jobs
        self._next_job_int = 0
        self.jobs: Dict[bytes, Dict[str, Any]] = {}

        # task events ring buffer (reference: gcs_task_manager.h:85)
        self.task_events: deque = deque(
            maxlen=GlobalConfig.task_events_buffer_size)
        # Monotone per-state totals of everything ever pushed, so the
        # rtpu_tasks_events_total exposition has counter semantics (the
        # ring buffer itself shrinks as entries fall out).
        self._task_event_counts: Dict[str, int] = defaultdict(int)

        # Cluster event log (reference: event.proto structured export):
        # typed, severity-tagged failure-forensics events in a bounded
        # ring; severities/types validated against the schema registry.
        self.cluster_events: deque = deque(
            maxlen=GlobalConfig.cluster_events_buffer_size)
        self._event_seq = 0
        # (type, severity) -> monotone count for the Prometheus counter.
        self._event_counts: Dict[Tuple[str, str], int] = defaultdict(int)

        # internal worker info registry (worker_id -> info)
        self.workers: Dict[bytes, Dict[str, Any]] = {}

        # user-defined metrics: source (pid string) -> (ts, snapshots)
        # (reference: per-node MetricsAgent registry aggregated by
        # Prometheus). Entries expire when a source stops pushing — the
        # same visibility a Prometheus target losing a process has;
        # counter resets are the scrape consumer's problem (rate()).
        self.user_metrics: Dict[str, Tuple[float, List[Dict[str, Any]]]] = {}
        # Monotonic series (counters/histograms) of expired sources, folded
        # here so cluster totals never go backwards when a worker exits.
        self._metric_tombstones: Dict[str, Dict[str, Any]] = {}

        # Request-scoped traces: trace-tagged SPAN events peeled off
        # push_task_events accumulate here until the root span arrives,
        # then tail-sample (observability/traces.py). Single-threaded
        # by design — this handler loop is the only caller.
        from ray_tpu_torch.observability.traces import TraceStore

        self.trace_store = TraceStore(
            maxlen=GlobalConfig.trace_store_maxlen,
            keep_threshold_s=GlobalConfig.trace_keep_threshold_s,
            sample_rate=GlobalConfig.trace_sample_rate,
            pending_max=GlobalConfig.trace_pending_max)

        # Control-plane decision ring: every autoscale / backpressure /
        # preemption action with the metric reading that triggered it,
        # so "why did it scale?" is answerable from the dashboard
        # (GET /api/controller) without scraping logs.
        self.ctrl_decisions: deque = deque(
            maxlen=GlobalConfig.ctrl_decisions_buffer_size)
        self._ctrl_decision_seq = 0

        # Cluster-wide prefix index: replica -> its newest published
        # set of KV hash-chain heads (stable_hash, depth) + tier
        # residency summary. A routing HINT, not a directory: entries
        # expire after serve_prefix_index_ttl_s without a re-publish,
        # and every consumer re-verifies against real tokens before
        # trusting a hash (serve/llm/kv_cache.stable_hash_prefix).
        self.prefix_index: Dict[str, Dict[str, Any]] = {}

        # Cross-worker train step matrix: every instrumented train /
        # learner worker publishes one row per step (worker, step,
        # wall_s, per-phase seconds, goodput snapshot). The row doubles
        # as the worker's step heartbeat: the straggler detector runs
        # on ingest, the stall watchdog ages the per-worker last-report
        # timestamps and auto-captures stacks from workers that go
        # quiet mid-run.
        self.train_steps: deque = deque(
            maxlen=GlobalConfig.train_steps_buffer_size)
        self._train_step_seq = 0
        self.train_workers: Dict[str, Dict[str, Any]] = {}
        self._train_straggler = None  # lazy StragglerDetector
        self._train_stragglers: deque = deque(maxlen=64)
        self._train_watchdog_task = None

        # Serve cost-accounting ring (observability/accounting.py):
        # every finished serve request publishes one cost row (tenant,
        # lane, trace_id, tokens, block/chip-seconds). Bounded deque +
        # monotone seq, windowed aggregation server-side: the bounded
        # TenantLedger folds rows on ingest and the per-lane SLOTracker
        # evaluates TTFT/TPOT attainment, recording SLO_BURN when both
        # burn windows trip.
        self.serve_accounting: deque = deque(
            maxlen=GlobalConfig.serve_accounting_buffer_size)
        self._serve_acct_seq = 0
        self._serve_ledger = None   # lazy accounting.TenantLedger
        self._serve_slo = None      # lazy accounting.SLOTracker

        # Program-attribution ring (observability/xla.py): every tracked
        # program publishes its cost rows here (flops, device bytes,
        # sampled MFU/MBU, roofline verdict). The ring keeps row history;
        # ``xla_latest`` keeps only each program's newest row, the fleet's
        # current program set that the summary ranks by FLOPs, device
        # bytes, and lost-to-roofline headroom.
        self.xla_programs: deque = deque(
            maxlen=GlobalConfig.xla_programs_buffer_size)
        self._xla_seq = 0
        self.xla_latest: Dict[tuple, Dict[str, Any]] = {}

        # When an autoscaler last read the cluster's load, and the gap
        # before that (its period): an actor no live node can fit waits
        # past its lease deadline while an autoscaler reads its demand.
        self._load_polls: List[float] = []
        self._actors_warned_pending: set = set()

        self._reschedule_on_start: List[bytes] = []
        self._register_handlers()
        # Actor/PG lifecycle transitions all publish; piggyback snapshot
        # dirty-marking there so bounce recovery stays fresh.
        self.pubsub.on_publish = self._on_publish
        self._health_task = None
        self._snapshot_path: Optional[str] = None
        self._snapshot_task = None
        self._snapshot_dirty = False
        self._snapshot_errors = 0

    # ------------------------------------------------------------------ boot
    def start(self) -> int:
        port = self.server.start()
        self._health_task = get_io_loop().submit(self._health_loop())
        self._driver_watch_task = get_io_loop().submit(
            self._driver_watch_loop())
        self._train_watchdog_task = get_io_loop().submit(
            self._train_watchdog_loop())
        for actor_id in self._reschedule_on_start:
            get_io_loop().submit(self._schedule_actor(actor_id))
        self._reschedule_on_start = []
        if self._snapshot_path:
            self._snapshot_task = get_io_loop().submit(self._snapshot_loop())
        return port

    def _on_publish(self, channel: str) -> None:
        if channel in ("actor", "pg"):
            self._snapshot_dirty = True

    # ------------------------------------------------------- persistence
    def enable_snapshots(self, path: str) -> None:
        """Persist the durable tables (KV, jobs, named actors) to `path`
        periodically; load an existing snapshot now. Runtime state (nodes,
        leases, live actors) intentionally rebuilds via re-registration."""
        import pickle

        self._snapshot_path = path
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    snap = pickle.load(f)
                for ns, entries in snap.get("kv", {}).items():
                    self.kv[ns].update(entries)
                self.jobs.update(snap.get("jobs", {}))
                self._next_job_int = max(self._next_job_int,
                                         snap.get("next_job_int", 0))
                # Live-actor and PG tables survive a control-plane bounce
                # (reference: redis-backed gcs_actor_table): addresses may
                # be stale; death reports and failed pushes correct them.
                for actor_id, rec in snap.get("actors", {}).items():
                    rec = dict(rec)
                    self.actors[actor_id] = rec
                    self._actor_events[actor_id] = asyncio.Event()
                    if rec.get("state") == ALIVE:
                        self._actor_events[actor_id].set()
                    elif rec.get("state") in (PENDING_CREATION, RESTARTING):
                        # Their scheduling coroutine died with the old
                        # process; restart it once the loop is up.
                        self._reschedule_on_start.append(actor_id)
                self.named_actors.update(snap.get("named_actors", {}))
                self.placement_groups.update(snap.get("pgs", {}))
            except Exception as e:  # corrupt snapshot: recover empty, SAY SO
                import sys

                print(f"[gcs] WARNING: snapshot at {path} unreadable "
                      f"({type(e).__name__}: {e}); starting without "
                      "recovered state", file=sys.stderr, flush=True)

    def _build_snapshot(self) -> dict:
        """Consistent one-level-deep copies, taken ON the event loop so
        handler mutations can't race the pickle (observed under a
        500-actor storm: 'dictionary changed size during iteration'
        from the executor thread)."""
        actors = {}
        for aid, rec in list(self.actors.items()):
            actors[aid] = {k: v for k, v in rec.items() if k != "handle"}
        return {
            "kv": {ns: dict(entries)
                   for ns, entries in self.kv.items()},
            "jobs": {k: dict(v) if isinstance(v, dict) else v
                     for k, v in self.jobs.items()},
            "next_job_int": self._next_job_int,
            "actors": actors,
            "named_actors": dict(self.named_actors),
            "pgs": {k: dict(v) if isinstance(v, dict) else v
                    for k, v in self.placement_groups.items()},
        }

    def _write_snapshot(self, snap: dict) -> None:
        import pickle

        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(snap, f)
        os.replace(tmp, self._snapshot_path)

    async def _snapshot_loop(self):
        import sys

        while True:
            await asyncio.sleep(5.0)
            if not self._snapshot_dirty:
                continue
            self._snapshot_dirty = False
            try:
                # Copies on-loop (consistent), pickle+write off-loop: a
                # large KV (exported functions) must not stall
                # heartbeat handling.
                snap = self._build_snapshot()
                await asyncio.get_running_loop().run_in_executor(
                    None, self._write_snapshot, snap)
                self._snapshot_errors = 0
            except Exception as e:
                self._snapshot_dirty = True
                self._snapshot_errors += 1
                if self._snapshot_errors in (1, 10, 100):
                    print(f"[gcs] WARNING: snapshot write failed x"
                          f"{self._snapshot_errors} "
                          f"({type(e).__name__}: {e})",
                          file=sys.stderr, flush=True)

    def _register_handlers(self):
        s = self.server
        for name in [
            "register_node", "heartbeat", "get_all_nodes", "drain_node",
            "kv_put", "kv_get", "kv_del", "kv_keys", "kv_exists",
            "register_actor", "register_actors", "get_actor_info",
            "get_named_actor",
            "list_named_actors", "kill_actor", "gc_actor",
            "report_actor_death",
            "wait_actor_ready", "list_actors",
            "create_placement_group", "remove_placement_group",
            "get_placement_group", "wait_placement_group_ready",
            "list_placement_groups",
            "next_job_id", "register_job", "mark_job_finished", "list_jobs",
            "get_job_info",
            "publish", "poll", "pubsub_seq", "push_task_events",
            "get_task_events",
            "register_worker", "list_workers", "get_system_config",
            "cluster_resources", "available_resources", "internal_stats",
            "metrics_text", "get_cluster_load", "push_metrics",
            "user_metrics_summary",
            "report_cluster_event", "list_cluster_events",
            "summary_cluster_events",
            "report_ctrl_decision", "list_ctrl_decisions",
            "get_trace", "list_traces", "trace_stats",
            "report_prefix_index", "lookup_prefix_index",
            "report_train_steps", "list_train_steps", "train_summary",
            "report_serve_accounting", "list_serve_accounting",
            "serve_accounting_summary",
            "report_xla_programs", "list_xla_programs", "xla_summary",
            "autoscaler_running",
        ]:
            s.register(name, getattr(self, f"_h_{name}"))

    # --------------------------------------------------------- cluster events
    def _record_event(self, event_type: str, message: str,
                      severity: Optional[str] = None,
                      node_id: Optional[str] = None, **extra) -> None:
        """Append one typed event to the ClusterEventLog. ERROR-severity
        events are additionally broadcast on the "logs" pubsub channel
        so every driver echoes them (reference: error-message pubsub)."""
        from ray_tpu_torch.observability import events as _events

        try:
            event = _events.make_event(event_type, message,
                                       severity=severity,
                                       node_id=node_id, **extra)
        except ValueError as e:
            print(f"[gcs] WARNING: dropping malformed cluster event: {e}",
                  file=sys.stderr, flush=True)
            return
        self._event_seq += 1
        event["seq"] = self._event_seq
        self.cluster_events.append(event)
        self._event_counts[(event["type"], event["severity"])] += 1
        if event["severity"] == "ERROR":
            self.pubsub.publish("logs", {"cluster_event": event})

    async def _h_report_cluster_event(self, event_type, message,
                                      severity=None, node_id=None,
                                      extra=None):
        self._record_event(event_type, message, severity=severity,
                           node_id=node_id, **(extra or {}))
        return True

    async def _h_list_cluster_events(self, event_type=None, severity=None,
                                     node_id=None, limit=100):
        """Newest-last slice of the event ring, optionally filtered by
        type, severity, and node-id hex prefix."""
        out = []
        for e in self.cluster_events:
            if event_type is not None and e["type"] != event_type:
                continue
            if severity is not None and e["severity"] != severity:
                continue
            if node_id is not None and not (
                    e.get("node_id") or "").startswith(node_id):
                continue
            out.append(e)
        return out[-max(int(limit), 0):]

    async def _h_summary_cluster_events(self):
        """Rollup by (type, severity) over everything ever recorded —
        counts are monotone, unlike the bounded ring itself."""
        by_type: Dict[str, Dict[str, int]] = defaultdict(dict)
        for (etype, sev), n in self._event_counts.items():
            by_type[etype][sev] = n
        return {"total_recorded": self._event_seq,
                "in_buffer": len(self.cluster_events),
                "by_type": {t: dict(v) for t, v in by_type.items()}}

    # ------------------------------------------------- control-plane decisions
    async def _h_report_ctrl_decision(self, controller: str, action: str,
                                      reason: str = "", reading=None,
                                      node_id=None):
        """One control-plane decision (autoscale, backpressure adjust,
        memory preemption) with the metric reading that triggered it."""
        self._ctrl_decision_seq += 1
        self.ctrl_decisions.append({
            "seq": self._ctrl_decision_seq, "ts": time.time(),
            "controller": str(controller), "action": str(action),
            "reason": str(reason), "reading": dict(reading or {}),
            "node_id": node_id,
        })
        return True

    async def _h_list_ctrl_decisions(self, controller=None, action=None,
                                     limit=100):
        """Newest-last slice of the decision ring, optionally filtered."""
        out = []
        for d in self.ctrl_decisions:
            if controller is not None and d["controller"] != controller:
                continue
            if action is not None and d["action"] != action:
                continue
            out.append(d)
        return out[-max(int(limit), 0):]

    # ------------------------------------------------- cluster prefix index
    async def _h_report_prefix_index(self, replica, heads, tiers=None):
        """One LLM replica's cache-aware-routing hint: the hash-chain
        heads it can serve without prefilling (hottest first, capped at
        serve_prefix_index_max_heads) plus a tier residency summary.
        Last write wins per replica; the report IS the heartbeat — a
        replica that stops publishing ages out at lookup."""
        cap = int(GlobalConfig.serve_prefix_index_max_heads)
        self.prefix_index[str(replica)] = {
            "heads": [(int(h), int(d)) for h, d in list(heads)[:cap]],
            "tiers": dict(tiers or {}),
            "ts": time.time(),
        }
        return True

    async def _h_lookup_prefix_index(self):
        """TTL-filtered snapshot: {replica: {heads, tiers, age_s}}.
        Expired entries are dropped here (lazy expiry — no sweeper
        task to keep alive across bounces)."""
        ttl = float(GlobalConfig.serve_prefix_index_ttl_s)
        now = time.time()
        out: Dict[str, Any] = {}
        for rep in list(self.prefix_index):
            rec = self.prefix_index[rep]
            age = now - rec["ts"]
            if age > ttl:
                del self.prefix_index[rep]
                continue
            out[rep] = {"heads": list(rec["heads"]),
                        "tiers": dict(rec["tiers"]),
                        "age_s": age}
        return out

    # --------------------------------------------------- train step matrix
    def _train_detector(self):
        if self._train_straggler is None:
            from ray_tpu_torch.observability.goodput import StragglerDetector

            self._train_straggler = StragglerDetector(
                threshold=float(GlobalConfig.train_straggler_threshold),
                window=int(GlobalConfig.train_straggler_window))
        return self._train_straggler

    async def _h_report_train_steps(self, row=None, rows=None):
        """Train/learner workers publish step rows here (worker, step,
        wall_s, phases{phase: seconds}, optional goodput snapshot). One
        row per step, batched via `rows` when a worker catches up. The
        report IS the worker's heartbeat — the stall watchdog ages
        these, and a row with ``done: true`` marks the worker idle so a
        finished run never trips it. The straggler detector runs on
        ingest and records TRAIN_STRAGGLER naming the dominant phase."""
        for r in list(rows or []) + ([row] if row else []):
            try:
                self._ingest_train_row(dict(r))
            except Exception as e:
                print(f"[gcs] WARNING: dropping malformed train step row: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
        return True

    def _ingest_train_row(self, row: dict) -> None:
        worker = str(row.get("worker") or "")
        if not worker:
            return
        info = self.train_workers.setdefault(worker, {
            "worker": worker, "walls": deque(maxlen=32), "steps": 0,
            "last_step": None, "stalled": False, "done": False,
            "straggler": None, "goodput": None,
        })
        info["last_ts"] = time.monotonic()
        for key in ("worker_id", "node_id"):
            if row.get(key) is not None:
                info[key] = row[key]
        if row.get("done"):
            info["done"] = True
            info["stalled"] = False
            if isinstance(row.get("goodput"), dict):
                info["goodput"] = dict(row["goodput"])
            return
        # Any real step row revives a worker previously marked done or
        # stalled (next kick / recovered hang).
        info["done"] = False
        info["stalled"] = False
        rec = {
            "worker": worker,
            "step": int(row.get("step", 0)),
            "wall_s": float(row.get("wall_s", 0.0)),
            "phases": {str(k): float(v)
                       for k, v in dict(row.get("phases") or {}).items()},
            "recv_ts": time.time(),
        }
        if isinstance(row.get("goodput"), dict):
            rec["goodput"] = dict(row["goodput"])
            info["goodput"] = rec["goodput"]
        self._train_step_seq += 1
        rec["seq"] = self._train_step_seq
        self.train_steps.append(rec)
        info["steps"] += 1
        info["last_step"] = rec["step"]
        info["walls"].append(rec["wall_s"])
        flag = self._train_detector().observe(
            worker, rec["step"], rec["wall_s"], rec["phases"])
        if flag:
            info["straggler"] = flag
            self._train_stragglers.append(dict(flag, ts=time.time()))
            node_id = info.get("node_id")
            self._record_event(
                "TRAIN_STRAGGLER",
                f"train worker {worker} is a straggler: mean step "
                f"{flag['mean_step_s']:.3f}s vs pod median "
                f"{flag['median_step_s']:.3f}s ({flag['ratio']:.2f}x); "
                f"dominant phase {flag['dominant_phase']} "
                f"(+{flag['dominant_excess_s']:.3f}s over peers)",
                node_id=node_id.hex() if hasattr(node_id, "hex")
                else node_id,
                worker=worker, step=flag["step"],
                ratio=round(float(flag["ratio"]), 3),
                dominant_phase=flag["dominant_phase"],
                dominant_excess_s=round(
                    float(flag["dominant_excess_s"]), 4),
                mean_step_s=round(float(flag["mean_step_s"]), 4),
                median_step_s=round(float(flag["median_step_s"]), 4))

    async def _h_list_train_steps(self, worker=None, limit=200):
        """Newest-last slice of the step-row ring, optionally filtered
        by worker label."""
        out = []
        for rec in self.train_steps:
            if worker is not None and rec["worker"] != worker:
                continue
            out.append(rec)
        return out[-max(int(limit), 0):]

    async def _h_train_summary(self):
        """The cross-worker rollup behind `util.state.train_summary()`
        (the reference's dashboard also serves it as `GET /api/train`):
        per-worker step stats + stall/straggler
        flags, the cluster goodput ratio (productive seconds over
        accounted seconds, weighted by each worker's ledger), lost
        seconds by cause, and per-phase means over the buffered rows."""
        now = time.monotonic()
        phase_tot: Dict[str, float] = defaultdict(float)
        phase_n: Dict[str, int] = defaultdict(int)
        for rec in self.train_steps:
            for ph, s in rec["phases"].items():
                phase_tot[ph] += s
                phase_n[ph] += 1
        workers = []
        tot_prod = tot_acc = 0.0
        lost: Dict[str, float] = defaultdict(float)
        for w in sorted(self.train_workers):
            info = self.train_workers[w]
            walls = [s for s in info["walls"]]
            node_id = info.get("node_id")
            row = {
                "worker": w,
                "steps": info["steps"],
                "last_step": info["last_step"],
                "age_s": round(now - info.get("last_ts", now), 3),
                "mean_step_s": (sum(walls) / len(walls)) if walls else None,
                "stalled": info["stalled"],
                "done": info["done"],
                "straggler": info.get("straggler"),
                "node_id": node_id.hex() if hasattr(node_id, "hex")
                           else node_id,
            }
            g = info.get("goodput")
            if g:
                row["goodput_ratio"] = g.get("goodput_ratio")
                tot_prod += float(g.get("productive_s") or 0.0)
                tot_acc += float(g.get("accounted_s") or 0.0)
                for cause, s in dict(g.get("lost_s") or {}).items():
                    lost[cause] += float(s)
            workers.append(row)
        return {
            "workers": workers,
            "steps_in_buffer": len(self.train_steps),
            "steps_recorded": self._train_step_seq,
            "goodput_ratio": (tot_prod / tot_acc) if tot_acc else None,
            "productive_s": tot_prod,
            "accounted_s": tot_acc,
            "lost_seconds": dict(lost),
            "phase_mean_s": {ph: phase_tot[ph] / phase_n[ph]
                             for ph in phase_tot},
            "stragglers": list(self._train_stragglers),
            "stalled": [r["worker"] for r in workers if r["stalled"]],
        }

    # ------------------------------------------------- serve accounting
    def _serve_acct_ledger(self):
        if self._serve_ledger is None:
            from ray_tpu_torch.observability.accounting import TenantLedger

            self._serve_ledger = TenantLedger(
                max_tenants=int(
                    GlobalConfig.serve_accounting_max_tenants))
        return self._serve_ledger

    def _serve_slo_tracker(self):
        if self._serve_slo is None:
            from ray_tpu_torch.observability.accounting import SLOTracker

            self._serve_slo = SLOTracker()
        return self._serve_slo

    async def _h_report_serve_accounting(self, row=None, rows=None):
        """Serve engines publish one cost row per finished request
        (RequestMeter.finalize shape), batched via ``rows`` when a
        replica catches up. Ingest folds the bounded tenant ledger and
        runs the SLO burn evaluation — the row is both the billing
        record and the lane's attainment sample."""
        for r in list(rows or []) + ([row] if row else []):
            try:
                self._ingest_serve_row(dict(r))
            except Exception as e:
                print(f"[gcs] WARNING: dropping malformed serve "
                      f"accounting row: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
        return True

    def _ingest_serve_row(self, row: dict) -> None:
        def _opt(key):
            v = row.get(key)
            return None if v is None else float(v)

        # Rows cross process boundaries and land on JSON surfaces
        # (/api/accounting) — a raw-bytes node id must become hex here.
        node_id = row.get("node_id")
        rec = {
            "tenant": str(row.get("tenant") or "default"),
            "model": str(row.get("model") or ""),
            "lane": str(row.get("lane") or "interactive"),
            "trace_id": row.get("trace_id"),
            "request_id": row.get("request_id"),
            "node_id": (node_id.hex() if hasattr(node_id, "hex")
                        else node_id),
            "tokens_out": int(row.get("tokens_out") or 0),
            "prefill_tokens_computed": int(
                row.get("prefill_tokens_computed") or 0),
            "prefill_tokens_avoided": int(
                row.get("prefill_tokens_avoided") or 0),
            "spec_proposed": int(row.get("spec_proposed") or 0),
            "spec_accepted": int(row.get("spec_accepted") or 0),
            "block_seconds": float(row.get("block_seconds") or 0.0),
            "chip_seconds": {
                str(k): float(v) for k, v in
                dict(row.get("chip_seconds") or {}).items()},
            "chip_seconds_total": float(
                row.get("chip_seconds_total") or 0.0),
            "migrations": int(row.get("migrations") or 0),
            "queue_wait_s": _opt("queue_wait_s"),
            "ttft_s": _opt("ttft_s"),
            "tpot_s": _opt("tpot_s"),
            "e2e_s": _opt("e2e_s"),
            "finish_reason": row.get("finish_reason"),
            "recv_ts": time.time(),
        }
        self._serve_acct_seq += 1
        rec["seq"] = self._serve_acct_seq
        self.serve_accounting.append(rec)
        self._serve_acct_ledger().fold(rec)
        # Only rows with a measured first token are SLO samples — a
        # cancelled-in-queue request has no latency to attain.
        if rec["ttft_s"] is None:
            return
        flag = self._serve_slo_tracker().observe(
            rec["lane"], rec["ttft_s"], rec["tpot_s"])
        if flag:
            self._record_event(
                "SLO_BURN",
                f"serve lane {flag['lane']} is burning its SLO error "
                f"budget: fast burn {flag['fast_burn']}x over "
                f"{flag['window_fast_s']:.0f}s (attainment "
                f"{flag['attainment_fast']:.4f} vs objective "
                f"{flag['objective']}), slow burn {flag['slow_burn']}x "
                f"over {flag['window_slow_s']:.0f}s; targets "
                f"ttft<={flag['ttft_target_s']}s "
                f"tpot<={flag['tpot_target_s']}s",
                lane=flag["lane"],
                fast_burn=flag["fast_burn"],
                slow_burn=flag["slow_burn"],
                attainment_fast=flag["attainment_fast"],
                attainment_slow=flag["attainment_slow"],
                objective=flag["objective"],
                ttft_target_s=flag["ttft_target_s"],
                tpot_target_s=flag["tpot_target_s"])

    async def _h_list_serve_accounting(self, tenant=None, lane=None,
                                       trace_id=None, limit=200):
        """Newest-last slice of the cost-row ring, optionally filtered
        by tenant, lane, or exact trace id (the ``x-trace-id`` a routed
        request returned)."""
        out = []
        for rec in self.serve_accounting:
            if tenant is not None and rec["tenant"] != tenant:
                continue
            if lane is not None and rec["lane"] != lane:
                continue
            if trace_id is not None and rec["trace_id"] != trace_id:
                continue
            out.append(rec)
        return out[-max(int(limit), 0):]

    async def _h_serve_accounting_summary(self, top_n=None,
                                          trace_id=None):
        """The rollup behind ``util.state.serve_accounting()`` and
        ``GET /api/accounting``: top-N tenants by chip-seconds (the
        "which tenant is eating the fleet?" answer), per-lane SLO
        attainment/burn, ring occupancy — plus, given ``trace_id``,
        that request's own cost row."""
        if top_n is None:
            top_n = int(GlobalConfig.serve_accounting_top_n)
        ledger = self._serve_acct_ledger()
        out = {
            "tenants": ledger.top(int(top_n)),
            "tenants_tracked": len(ledger),
            "rows_in_buffer": len(self.serve_accounting),
            "rows_recorded": self._serve_acct_seq,
            "slo": self._serve_slo_tracker().snapshot(),
        }
        if trace_id is not None:
            out["request"] = next(
                (rec for rec in reversed(self.serve_accounting)
                 if rec["trace_id"] == trace_id), None)
        return out

    # ---------------------------------------------- program cost rows
    _XLA_FLOAT_FIELDS = (
        "flops", "bytes_accessed", "transcendentals", "arg_bytes",
        "out_bytes", "temp_bytes", "alias_bytes", "peak_hbm_bytes",
        "compile_seconds", "wall_s", "achieved_flops_per_s",
        "achieved_bytes_per_s", "mfu", "mbu", "exposed_comm_fraction",
        "lost_roofline_s_per_call", "lost_roofline_s_total")

    async def _h_report_xla_programs(self, row=None, rows=None):
        """Tracked-program processes publish cost rows here: one on every
        new program (its counts) and one per sampled wall (MFU/MBU +
        verdict refresh). Batched via ``rows`` when a publisher catches
        up."""
        for r in list(rows or []) + ([row] if row else []):
            try:
                self._ingest_xla_row(dict(r))
            except Exception as e:
                print(f"[gcs] WARNING: dropping malformed program row: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
        return True

    def _ingest_xla_row(self, row: dict) -> None:
        fn = str(row.get("fn") or "")
        signature = str(row.get("signature") or "")
        if not fn or not signature:
            raise ValueError("program row needs fn and signature")
        rec: Dict[str, Any] = {"fn": fn, "signature": signature}
        for key in self._XLA_FLOAT_FIELDS:
            v = row.get(key)
            rec[key] = None if v is None else float(v)
        rec["calls"] = int(row.get("calls") or 0)
        rec["samples"] = int(row.get("samples") or 0)
        rec["verdict"] = str(row.get("verdict") or "unsampled")
        rec["spec"] = str(row.get("spec") or "unknown")
        rec["measurement"] = str(row.get("measurement") or "unknown")
        rec["pid"] = int(row.get("pid") or 0)
        node_id = row.get("node_id")
        rec["node_id"] = node_id.hex() if hasattr(node_id, "hex") \
            else node_id
        rec["recv_ts"] = time.time()
        self._xla_seq += 1
        rec["seq"] = self._xla_seq
        self.xla_programs.append(rec)
        self.xla_latest[(rec["node_id"], rec["pid"], fn, signature)] = rec
        # The latest-view is bounded by the same knob as the ring: evict
        # the stalest program when a churning fleet overflows it.
        while len(self.xla_latest) > (self.xla_programs.maxlen or 0) > 0:
            oldest = min(self.xla_latest,
                         key=lambda k: self.xla_latest[k]["seq"])
            del self.xla_latest[oldest]

    async def _h_list_xla_programs(self, fn=None, verdict=None,
                                   limit=200):
        """Newest-last slice of the program-row ring, optionally filtered
        by function name or roofline verdict."""
        out = []
        for rec in self.xla_programs:
            if fn is not None and rec["fn"] != fn:
                continue
            if verdict is not None and rec["verdict"] != verdict:
                continue
            out.append(rec)
        return out[-max(int(limit), 0):]

    async def _h_xla_summary(self, top_n=8):
        """The rollup behind ``util.state.xla_summary()`` and
        ``GET /api/programs``: the fleet's current program set ranked by
        cumulative FLOPs, peak device bytes, and lost-to-roofline
        headroom seconds, plus verdict/measurement counts (an all-cpu
        ``measurements`` dict says the ratios prove plumbing, not
        performance)."""
        top_n = max(int(top_n), 1)
        rows = list(self.xla_latest.values())

        def total_flops(r):
            return (r["flops"] or 0.0) * max(r["calls"], 1)

        sampled = [r for r in rows
                   if r.get("lost_roofline_s_total") is not None]
        verdicts: Dict[str, int] = defaultdict(int)
        measurements: Dict[str, int] = defaultdict(int)
        for r in rows:
            verdicts[r["verdict"]] += 1
            measurements[r["measurement"]] += 1
        return {
            "programs": len(rows),
            "rows_in_buffer": len(self.xla_programs),
            "rows_recorded": self._xla_seq,
            "total_flops": sum(total_flops(r) for r in rows),
            "total_peak_hbm_bytes": sum(
                r["peak_hbm_bytes"] or 0.0 for r in rows),
            "lost_roofline_s_total": sum(
                r["lost_roofline_s_total"] for r in sampled),
            "verdicts": dict(verdicts),
            "measurements": dict(measurements),
            "top_by_flops": sorted(
                rows, key=total_flops, reverse=True)[:top_n],
            "top_by_hbm": sorted(
                rows, key=lambda r: r["peak_hbm_bytes"] or 0.0,
                reverse=True)[:top_n],
            "top_by_headroom": sorted(
                sampled, key=lambda r: r["lost_roofline_s_total"],
                reverse=True)[:top_n],
        }

    async def _train_watchdog_loop(self):
        """Stall watchdog: a worker that published step rows and then
        went quiet for longer than `train_stall_heartbeats` times its
        own median step wall (floored at `train_stall_min_timeout_s`)
        is marked stalled and a TRAIN_STALL event is recorded WITH the
        worker's thread stacks auto-captured via its raylet's
        dump_stacks — the forensics arrive with the page, not after
        someone ssh'es in. Workers that reported ``done`` are exempt
        until their next row."""
        from statistics import median

        while True:
            await asyncio.sleep(
                float(GlobalConfig.train_stall_check_interval_s))
            if not self.train_workers:
                continue
            beats = int(GlobalConfig.train_stall_heartbeats)
            floor = float(GlobalConfig.train_stall_min_timeout_s)
            now = time.monotonic()
            for w, info in list(self.train_workers.items()):
                if info.get("done") or info.get("stalled"):
                    continue
                if not info["steps"]:
                    continue
                walls = [s for s in info["walls"] if s > 0]
                timeout = max(floor,
                              beats * (median(walls) if walls else 0.0))
                age = now - info.get("last_ts", now)
                if age <= timeout:
                    continue
                info["stalled"] = True
                stacks = await self._capture_train_stacks(info)
                node_id = info.get("node_id")
                self._record_event(
                    "TRAIN_STALL",
                    f"train worker {w} stalled: no step report for "
                    f"{age:.1f}s (timeout {timeout:.1f}s after "
                    f"{info['steps']} steps); thread stacks "
                    + ("attached" if stacks else "unavailable"),
                    node_id=node_id.hex() if hasattr(node_id, "hex")
                    else node_id,
                    worker=w, age_s=round(age, 3),
                    timeout_s=round(timeout, 3),
                    last_step=info["last_step"],
                    stacks=stacks)

    async def _capture_train_stacks(self, info: dict):
        """Best-effort dump_stacks against the stalled worker's raylet;
        returns formatted stack text (truncated) or None. Never raises —
        forensics failing must not take the watchdog down with it."""
        node_id = info.get("node_id")
        if node_id is None:
            return None
        client = self._client_for_node(node_id)
        if client is None:
            return None
        try:
            reply = await client.acall(
                "dump_stacks", worker_id=info.get("worker_id"),
                timeout=15)
        except Exception:
            return None
        texts = []
        for whex, rec in (reply or {}).items():
            if isinstance(rec, dict) and rec.get("stacks"):
                texts.append(f"worker {whex[:12]}:\n{rec['stacks']}")
        return "\n\n".join(texts)[:20000] or None

    # --------------------------------------------------------------- metrics
    async def _h_metrics_text(self) -> str:
        """Cluster metrics in Prometheus exposition format (reference:
        `stats/metric_defs.h` + MetricsAgent -> Prometheus scrape)."""
        # Naming discipline (linted by scripts/check_metrics.py): the
        # `_total` suffix is reserved for counters; state-breakdown
        # gauges export without it.
        lines = [
            "# HELP rtpu_nodes Nodes by liveness state.",
            "# TYPE rtpu_nodes gauge",
        ]
        by_state: Dict[str, int] = defaultdict(int)
        for info in self.nodes.values():
            by_state[info["state"]] += 1
        for state, n in by_state.items():
            lines.append(f'rtpu_nodes{{state="{state}"}} {n}')

        lines += ["# HELP rtpu_actors Actors by lifecycle state.",
                  "# TYPE rtpu_actors gauge"]
        actor_states: Dict[str, int] = defaultdict(int)
        for a in self.actors.values():
            actor_states[a.get("state", "UNKNOWN")] += 1
        for state, n in actor_states.items():
            lines.append(f'rtpu_actors{{state="{state}"}} {n}')

        # Counter semantics: monotone totals of everything ever pushed,
        # NOT a scan of the ring buffer (which shrinks as entries age
        # out and would make rate() see phantom resets).
        lines += ["# HELP rtpu_tasks_events_total Task lifecycle events "
                  "recorded since GCS start.",
                  "# TYPE rtpu_tasks_events_total counter"]
        for state, n in self._task_event_counts.items():
            lines.append(f'rtpu_tasks_events_total{{state="{state}"}} {n}')

        lines += ["# HELP rtpu_cluster_events_total Cluster events "
                  "recorded since GCS start, by type and severity.",
                  "# TYPE rtpu_cluster_events_total counter"]
        for (etype, sev), n in self._event_counts.items():
            lines.append(
                f'rtpu_cluster_events_total{{type="{etype}",'
                f'severity="{sev}"}} {n}')

        lines += ["# HELP rtpu_resource_capacity Cluster resource "
                  "capacity.",
                  "# TYPE rtpu_resource_capacity gauge",
                  "# HELP rtpu_resource_available Cluster resource "
                  "availability.",
                  "# TYPE rtpu_resource_available gauge"]
        for snap in self._nodes_snapshot():
            if snap["state"] != ALIVE:
                continue
            nid = snap["node_id"].hex()[:12]
            for key, val in snap["total"].items():
                lines.append(
                    f'rtpu_resource_capacity{{node="{nid}",'
                    f'resource="{key}"}} {val}')
            for key, val in snap["available"].items():
                lines.append(
                    f'rtpu_resource_available{{node="{nid}",'
                    f'resource="{key}"}} {val}')

        lines += ["# HELP rtpu_placement_groups Placement groups by "
                  "state.",
                  "# TYPE rtpu_placement_groups gauge"]
        pg_states: Dict[str, int] = defaultdict(int)
        for pg in self.placement_groups.values():
            pg_states[pg.get("state", "UNKNOWN")] += 1
        for state, n in pg_states.items():
            lines.append(
                f'rtpu_placement_groups{{state="{state}"}} {n}')

        # Tail-sampled trace store health: monotone totals from
        # TraceStore.stats() plus the two occupancy gauges.
        ts = self.trace_store.stats()
        lines += ["# HELP rtpu_trace_kept_total Completed traces kept "
                  "by tail-sampling, by reason.",
                  "# TYPE rtpu_trace_kept_total counter",
                  f"rtpu_trace_kept_total {ts['kept']}",
                  "# HELP rtpu_trace_sampled_out_total Completed fast, "
                  "clean traces dropped by trace_sample_rate.",
                  "# TYPE rtpu_trace_sampled_out_total counter",
                  f"rtpu_trace_sampled_out_total {ts['sampled_out']}",
                  "# HELP rtpu_trace_evicted_pending_total Rootless "
                  "in-flight traces evicted at trace_pending_max.",
                  "# TYPE rtpu_trace_evicted_pending_total counter",
                  f"rtpu_trace_evicted_pending_total "
                  f"{ts['evicted_pending']}",
                  "# HELP rtpu_trace_evicted_kept_total Kept traces "
                  "aged out of the trace_store_maxlen LRU ring.",
                  "# TYPE rtpu_trace_evicted_kept_total counter",
                  f"rtpu_trace_evicted_kept_total {ts['evicted_kept']}",
                  "# HELP rtpu_trace_spans_seen_total Trace-tagged SPAN "
                  "events routed into the trace store.",
                  "# TYPE rtpu_trace_spans_seen_total counter",
                  f"rtpu_trace_spans_seen_total {ts['spans_seen']}",
                  "# HELP rtpu_trace_spans_dropped_total Spans dropped "
                  "at the per-trace span cap.",
                  "# TYPE rtpu_trace_spans_dropped_total counter",
                  f"rtpu_trace_spans_dropped_total {ts['spans_dropped']}",
                  "# HELP rtpu_trace_pending In-flight (rootless) "
                  "traces accumulating in the store.",
                  "# TYPE rtpu_trace_pending gauge",
                  f"rtpu_trace_pending {ts['pending']}",
                  "# HELP rtpu_trace_stored Kept traces currently "
                  "retrievable from the store.",
                  "# TYPE rtpu_trace_stored gauge",
                  f"rtpu_trace_stored {ts['stored']}"]
        # Serve SLO attainment/burn: the SLOTracker lives in THIS
        # process (evaluated on accounting-row ingest), so its gauges
        # export natively here rather than through the push path.
        if self._serve_slo is not None:
            slo = self._serve_slo.snapshot()
            if slo:
                lines += ["# HELP rtpu_serve_slo_attainment_ratio "
                          "Fraction of requests in the fast window "
                          "meeting the lane's TTFT/TPOT targets.",
                          "# TYPE rtpu_serve_slo_attainment_ratio gauge",
                          "# HELP rtpu_serve_slo_burn_rate SLO "
                          "error-budget burn rate per lane and window; "
                          "1.0 consumes budget exactly at the "
                          "objective's allowance.",
                          "# TYPE rtpu_serve_slo_burn_rate gauge"]
                for lane, ent in sorted(slo.items()):
                    if ent.get("attainment_fast") is not None:
                        lines.append(
                            f'rtpu_serve_slo_attainment_ratio'
                            f'{{lane="{lane}"}} '
                            f'{ent["attainment_fast"]}')
                    for window in ("fast", "slow"):
                        burn = ent.get(f"burn_{window}")
                        if burn is not None:
                            lines.append(
                                f'rtpu_serve_slo_burn_rate'
                                f'{{lane="{lane}",window="{window}"}} '
                                f'{burn}')
        lines.extend(self._render_user_metrics())
        return "\n".join(lines) + "\n"

    async def _h_push_metrics(self, source: str, records):
        self.user_metrics[source] = (time.time(), records)
        return True

    async def _h_user_metrics_summary(self, prefixes=None):
        """Aggregated user metrics as plain dicts (dashboard /api/serve).
        ``prefixes``: optional list of metric-name prefixes to keep."""
        metas, counters, gauges, hists, fresh, exemplars = \
            self._aggregate_user_metrics()
        now = time.time()
        out: Dict[str, Any] = {}
        for name, meta in metas.items():
            if prefixes and not any(name.startswith(p) for p in prefixes):
                continue
            typ = meta["type"]
            entry: Dict[str, Any] = {
                "type": typ, "description": meta.get("description", ""),
                # Age of the freshest live push carrying this metric —
                # the MetricsHub staleness signal. None means only
                # tombstones of exited sources remain.
                "age_s": (max(0.0, now - fresh[name])
                          if name in fresh else None)}
            if typ == "counter":
                entry["data"] = dict(counters[name])
            elif typ == "gauge":
                entry["data"] = dict(gauges[name])
            else:
                bounds = tuple(meta.get("boundaries", ()))
                data: Dict[str, Any] = {}
                for labels, cell in hists[name].items():
                    if len(cell) != len(bounds) + 3:
                        continue
                    count = cell[len(bounds) + 2]
                    total = cell[len(bounds) + 1]
                    data[labels] = {
                        "count": count, "sum": total,
                        "mean": (total / count) if count else 0.0,
                        "buckets": {str(b): cell[i]
                                    for i, b in enumerate(bounds)},
                    }
                entry["data"] = data
                entry["boundaries"] = list(bounds)
                # Max-valued exemplar per label set: the dashboard's
                # link from a latency histogram to the slowest
                # request's retrievable trace.
                entry["exemplars"] = {
                    k: dict(v) for k, v in exemplars.get(name, {}).items()}
            out[name] = entry
        return out

    @staticmethod
    def _esc_label(v: str) -> str:
        return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
                .replace('"', '\\"'))

    def _expire_user_metric_sources(self) -> None:
        """Drop sources that stopped pushing (dead workers) after 10 flush
        intervals. Their counters/histograms — cumulative by contract — are
        folded into the tombstone accumulator first, so `rtpu_*_total`
        series keep their contribution and never go backwards on worker
        exit. Gauges are per-process state and are simply dropped."""
        ttl = GlobalConfig.metrics_report_interval_s * 10
        now = time.time()
        for source in [s for s, (ts, _) in self.user_metrics.items()
                       if now - ts > ttl]:
            _, records = self.user_metrics.pop(source)
            self._fold_tombstones(records)

    def _fold_tombstones(self, records) -> None:
        for rec in records:
            typ = rec.get("type")
            if typ not in ("counter", "histogram"):
                continue
            name = rec.get("name")
            tomb = self._metric_tombstones.get(name)
            if tomb is None:
                tomb = dict(rec)
                tomb["data"] = {
                    k: (list(v) if isinstance(v, list) else float(v))
                    for k, v in rec.get("data", {}).items()}
                self._metric_tombstones[name] = tomb
                continue
            if tomb.get("type") != typ or (
                    typ == "histogram"
                    and tuple(tomb.get("boundaries", ()))
                    != tuple(rec.get("boundaries", ()))):
                continue  # conflicting registration; skip, never crash
            data = tomb["data"]
            for tagvals, cell in rec.get("data", {}).items():
                prior = data.get(tagvals)
                if prior is None:
                    data[tagvals] = (list(cell) if isinstance(cell, list)
                                     else float(cell))
                elif isinstance(cell, list):
                    if len(prior) == len(cell):
                        for i, v in enumerate(cell):
                            prior[i] += v
                else:
                    data[tagvals] = float(prior) + float(cell)
            # Exemplars are max-keep, not additive: a dead worker's
            # slowest-request link stays until a live one beats it.
            ex = rec.get("exemplars") or {}
            if ex:
                tex = tomb.setdefault("exemplars", {})
                for tagvals, e in ex.items():
                    prior_ex = tex.get(tagvals)
                    if (prior_ex is None or float(e.get("value", 0.0))
                            >= float(prior_ex.get("value", 0.0))):
                        tex[tagvals] = dict(e)

    def _aggregate_user_metrics(self):
        """Merge pushed ray_tpu_torch.util.metrics snapshots (live sources plus
        tombstones of expired ones): counters/histograms summed across
        processes, gauges kept per-process keyed by a pid label."""
        self._expire_user_metric_sources()
        # (name) -> merged view
        metas: Dict[str, Dict[str, Any]] = {}
        counters: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        gauges: Dict[str, Dict[str, float]] = defaultdict(dict)
        hists: Dict[str, Dict[str, List[float]]] = defaultdict(dict)
        # name -> labels -> max-valued exemplar across sources.
        exemplars: Dict[str, Dict[str, Dict[str, Any]]] = defaultdict(dict)
        # name -> newest push ts among live sources carrying it.
        fresh: Dict[str, float] = {}
        sources = list(self.user_metrics.items())
        if self._metric_tombstones:
            sources.append(
                ("(exited)", (0.0, list(self._metric_tombstones.values()))))
        for source, (push_ts, records) in sources:
            for rec in records:
                name, typ = rec["name"], rec["type"]
                if push_ts:  # tombstone pseudo-source pushes at ts 0.0
                    fresh[name] = max(fresh.get(name, 0.0), push_ts)
                meta = metas.setdefault(name, rec)
                if meta.get("type") != typ or (
                        typ == "histogram"
                        and tuple(meta.get("boundaries", ()))
                        != tuple(rec.get("boundaries", ()))):
                    # Conflicting registration from another process: skip
                    # this record rather than corrupt/crash the scrape.
                    continue
                keys = rec.get("tag_keys", ())
                for tagvals, cell in rec.get("data", {}).items():
                    labels = ",".join(
                        f'{k}="{self._esc_label(v)}"' for k, v in
                        zip(keys, tagvals.split(",") if keys else ()))
                    if typ == "counter":
                        counters[name][labels] += cell
                    elif typ == "gauge":
                        lbl = (labels + "," if labels else "") + \
                            f'pid="{self._esc_label(source)}"'
                        gauges[name][lbl] = cell
                    elif typ == "histogram":
                        acc = hists[name].get(labels)
                        if acc is None or len(acc) != len(cell):
                            hists[name][labels] = list(cell)
                        else:
                            for i, v in enumerate(cell):
                                acc[i] += v
                for tagvals, e in (rec.get("exemplars") or {}).items():
                    labels = ",".join(
                        f'{k}="{self._esc_label(v)}"' for k, v in
                        zip(keys, tagvals.split(",") if keys else ()))
                    prior = exemplars[name].get(labels)
                    if (prior is None or float(e.get("value", 0.0))
                            >= float(prior.get("value", 0.0))):
                        exemplars[name][labels] = dict(e)
        return metas, counters, gauges, hists, fresh, exemplars

    def _render_user_metrics(self) -> List[str]:
        """User metrics as Prometheus exposition lines."""
        metas, counters, gauges, hists, _, _ = \
            self._aggregate_user_metrics()
        out: List[str] = []
        for name, meta in metas.items():
            typ = meta["type"]
            full = f"rtpu_{name}"
            if meta.get("description"):
                out.append(f"# HELP {full} {meta['description']}")
            if typ in ("counter", "gauge"):
                out.append(f"# TYPE {full} {typ}")
                table = counters[name] if typ == "counter" else gauges[name]
                for labels, val in sorted(table.items()):
                    out.append(f"{full}{{{labels}}} {val}"
                               if labels else f"{full} {val}")
            elif typ == "histogram":
                out.append(f"# TYPE {full} histogram")
                bounds = meta.get("boundaries", ())
                for labels, cell in sorted(hists[name].items()):
                    if len(cell) != len(bounds) + 3:
                        continue  # mismatched push; never crash the scrape
                    prefix = labels + "," if labels else ""
                    for i, b in enumerate(bounds):
                        out.append(
                            f'{full}_bucket{{{prefix}le="{b}"}} {cell[i]}')
                    out.append(
                        f'{full}_bucket{{{prefix}le="+Inf"}} '
                        f'{cell[len(bounds)]}')
                    out.append(f"{full}_sum{{{labels}}} "
                               f"{cell[len(bounds) + 1]}"
                               if labels else
                               f"{full}_sum {cell[len(bounds) + 1]}")
                    out.append(f"{full}_count{{{labels}}} "
                               f"{cell[len(bounds) + 2]}"
                               if labels else
                               f"{full}_count {cell[len(bounds) + 2]}")
        return out

    def start_metrics_http(self, port: int = 0) -> int:
        """Serve GET /metrics for Prometheus scrapers (stdlib HTTP)."""
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        gcs = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                fut = get_io_loop().submit(gcs._h_metrics_text())
                body = fut.result(timeout=30).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = ThreadingHTTPServer((self.server._host, port), _Handler)
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="gcs-metrics-http").start()
        self._metrics_http = server
        port = server.server_address[1]
        self.kv["__internal__"]["metrics_port"] = str(port).encode()
        return port

    # ------------------------------------------------------------- node mgmt
    async def _h_register_node(self, node_id, addr, resources, labels,
                               object_store_capacity=0):
        self.nodes[node_id] = {
            "node_id": node_id,
            "addr": addr,  # (host, port) of the raylet RPC server
            "state": ALIVE,
            "labels": labels,
            "resources_total": resources,
            "object_store_capacity": object_store_capacity,
            "start_time": time.time(),
        }
        nr = NodeResources(ResourceSet(resources), labels)
        self.view.update_node(node_id, nr)
        self._view_seq += 1
        self._last_heartbeat[node_id] = time.monotonic()
        self.pubsub.publish("node", {"event": "ALIVE", "node_id": node_id,
                                     "addr": addr})
        self._record_event(
            "NODE_ADDED",
            f"node {node_id.hex()[:12]} joined at "
            f"{addr[0]}:{addr[1]} with {resources}",
            node_id=node_id.hex())
        return {"system_config": GlobalConfig.dump_system_config(),
                "nodes": self._nodes_snapshot()}

    async def _h_heartbeat(self, node_id, available, total, idle=True,
                           pending_demands=None, num_workers=0,
                           have_seq=0):
        if node_id not in self.nodes:
            return {"unknown": True}
        if os.environ.get("RAY_TPU_DEBUG_SCHED"):
            print(f"[gcs-hb {time.monotonic():.3f}] handled",
                  file=sys.stderr, flush=True)
        self._last_heartbeat[node_id] = time.monotonic()
        old = self.view.get(node_id)
        nr = NodeResources(ResourceSet(total), self.nodes[node_id]["labels"])
        nr.available = ResourceSet(available)
        if (old is None or old.available.to_dict() != nr.available.to_dict()
                or old.total.to_dict() != nr.total.to_dict()):
            self._view_seq += 1
        self.view.update_node(node_id, nr)
        self.nodes[node_id]["pending_demands"] = pending_demands or []
        self.nodes[node_id]["num_workers"] = num_workers
        if have_seq == self._view_seq:
            return {"seq": self._view_seq}
        return {"seq": self._view_seq, "nodes": self._nodes_snapshot()}

    async def _h_get_cluster_load(self):
        """Autoscaler state (reference: gcs_autoscaler_state_manager.h):
        per-node availability plus demands queued with no feasible home.
        The actors that no node can take now are the GCS's own demands:
        no raylet holds them, so they ride on the first live node's entry,
        beside that raylet's own. Each call is an autoscaler's poll
        (its only callers are the autoscalers' passes):
        ``_autoscaler_running`` reads their times."""
        self._load_polls = (self._load_polls + [time.monotonic()])[-2:]
        out = []
        for node_id, info in self.nodes.items():
            if info["state"] != ALIVE:
                continue
            nr = self.view.get(node_id)
            out.append({
                "node_id": node_id,
                "total": nr.total.to_dict() if nr else {},
                "available": nr.available.to_dict() if nr else {},
                "pending_demands": list(info.get("pending_demands", [])),
                "num_workers": info.get("num_workers", 0),
                "labels": info.get("labels", {}),
            })
        if out:
            out[0]["pending_demands"] += list(self._actor_demands.values())
        return out

    # The monitor's default period (pod_autoscaler.run_monitor_loop): the
    # floor of the period estimate while only one poll has come.
    _MONITOR_PERIOD_S = 5.0

    def _autoscaler_running(self) -> bool:
        """Whether an autoscaler reads the cluster's load: its last poll
        of ``get_cluster_load`` came within two of its periods (the gap
        between its last two polls, at least the monitor's default)."""
        if not self._load_polls:
            return False
        period = self._MONITOR_PERIOD_S
        if len(self._load_polls) == 2:
            period = max(period, self._load_polls[1] - self._load_polls[0])
        return time.monotonic() - self._load_polls[-1] <= 2 * period

    async def _h_autoscaler_running(self):
        """For a task's lease requester at its deadline: whether an
        infeasible lease should wait for the node an autoscaler adds."""
        return self._autoscaler_running()

    def _nodes_snapshot(self):
        out = []
        for node_id, info in self.nodes.items():
            nr = self.view.get(node_id)
            out.append({
                "node_id": node_id,
                "addr": info["addr"],
                "state": info["state"],
                "labels": info["labels"],
                "total": nr.total.to_dict() if nr else {},
                "available": nr.available.to_dict() if nr else {},
            })
        return out

    async def _h_get_all_nodes(self):
        return self._nodes_snapshot()

    async def _h_drain_node(self, node_id):
        await self._mark_node_dead(node_id, "drained")
        return True

    async def _mark_node_dead(self, node_id, reason):
        info = self.nodes.get(node_id)
        if info is None or info["state"] == DEAD:
            return
        last = self._last_heartbeat.get(node_id)
        age = f"{time.monotonic() - last:.2f}s" if last else "never"
        print(f"[gcs] node {node_id.hex()[:8]} marked DEAD: {reason} "
              f"(last heartbeat {age} ago)", file=sys.stderr, flush=True)
        info["state"] = DEAD
        self.view.remove_node(node_id)
        self._view_seq += 1
        self.pubsub.publish("node", {"event": "DEAD", "node_id": node_id,
                                     "reason": reason})
        # A drain is operator intent; anything else is a failure.
        self._record_event(
            "NODE_REMOVED",
            f"node {node_id.hex()[:12]} marked DEAD: {reason} "
            f"(last heartbeat {age} ago)",
            severity="WARNING" if reason == "drained" else "ERROR",
            node_id=node_id.hex(), reason=reason)
        # Fail/restart actors that lived on this node.
        for actor_id, a in list(self.actors.items()):
            if a.get("node_id") == node_id and a["state"] == ALIVE:
                await self._on_actor_failure(actor_id, f"node died: {reason}")

    @staticmethod
    def _tcp_alive(addr, timeout=2.0) -> bool:
        import socket as _socket

        try:
            _socket.create_connection(tuple(addr), timeout=timeout).close()
            return True
        except ConnectionRefusedError:
            return False  # nothing listening: the process is gone
        except OSError:
            # Timeout / transient network error: INDETERMINATE — a
            # stalled raylet with a full accept backlog drops SYNs, and
            # calling that dead would re-create the mass-kill this probe
            # exists to prevent. Defer; the hard cap still bounds a
            # truly wedged node.
            return True

    async def _health_loop(self):
        """Passive heartbeat age + ACTIVE liveness probe (reference:
        gcs_health_check_manager.cc does an active per-node check, not
        just heartbeat bookkeeping). A stale heartbeat alone conflates
        BUSY with DEAD: on an oversubscribed host a raylet booting
        hundreds of workers can stall its loop past the passive
        threshold while its process is perfectly alive — observed as
        'node DEAD after 6.2s' mass-killing 86 healthy actors. The TCP
        probe discriminates: the kernel completes the handshake from
        the listen backlog even when the event loop is stalled, so
        connect-success means alive-but-busy (defer death, up to a
        hard cap) and connect-refused means the process is gone (die
        at the fast passive threshold, keeping node-failure detection
        prompt for real crashes)."""
        period = GlobalConfig.health_check_period_ms / 1000
        threshold = GlobalConfig.health_check_failure_threshold
        hard_cap = period * threshold * 12  # truly wedged: still dies
        deferred = set()
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            suspects = []
            for node_id, last in list(self._last_heartbeat.items()):
                info = self.nodes.get(node_id)
                if info is None or info["state"] == DEAD:
                    continue
                age = now - last
                if age <= period * threshold:
                    deferred.discard(node_id)
                    continue
                suspects.append((node_id, age, info["addr"]))
            if not suspects:
                continue
            # Probe CONCURRENTLY: N simultaneously-stale nodes (the
            # motivating storm) must not serialize into 2s x N sweeps
            # that delay detecting a genuinely crashed node.
            alive = await asyncio.gather(*[
                loop.run_in_executor(None, self._tcp_alive, addr)
                for _, _, addr in suspects])
            for (node_id, age, _addr), is_alive in zip(suspects, alive):
                # Re-check JUST before the kill decision: a heartbeat
                # can arrive during the probe window, and killing on
                # the stale snapshot shot a node whose last heartbeat
                # was 0.66s old (observed).
                last = self._last_heartbeat.get(node_id)
                if (last is not None
                        and time.monotonic() - last <= period * threshold):
                    deferred.discard(node_id)
                    continue
                if age < hard_cap and is_alive:
                    if node_id not in deferred:
                        deferred.add(node_id)
                        print(f"[gcs] node {node_id.hex()[:8]} heartbeat "
                              f"stale ({age:.1f}s) but TCP-alive; "
                              f"deferring death (busy host)",
                              file=sys.stderr, flush=True)
                    continue
                deferred.discard(node_id)
                await self._mark_node_dead(node_id, "health check failed")

    async def _driver_watch_loop(self):
        """A job ends with its driver process (reference: the GCS job
        manager marks a job dead when its driver disconnects, and the
        job's actors and placement groups go with it). Each period, every
        RUNNING job's driver server gets _health_loop's TCP probe; a
        driver refused ``health_check_failure_threshold`` times in a row
        is gone, and its job is ended as if it had called shutdown(): what
        it leased (a GPU actor, a bundle) returns to the cluster."""
        period = GlobalConfig.health_check_period_ms / 1000
        threshold = GlobalConfig.health_check_failure_threshold
        misses: Dict[bytes, int] = {}
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(period)
            running = [(job_id, tuple(job["driver_addr"]))
                       for job_id, job in list(self.jobs.items())
                       if job.get("state") == "RUNNING"
                       and job.get("driver_addr")]
            alive = await asyncio.gather(*[
                loop.run_in_executor(None, self._tcp_alive, addr)
                for _, addr in running])
            for (job_id, addr), is_alive in zip(running, alive):
                if is_alive:
                    misses.pop(job_id, None)
                    continue
                misses[job_id] = misses.get(job_id, 0) + 1
                if misses[job_id] >= threshold:
                    del misses[job_id]
                    await self._end_job_of_dead_driver(job_id, addr)

    async def _end_job_of_dead_driver(self, job_id, addr):
        job = self.jobs.get(job_id)
        if job is None or job.get("state") != "RUNNING":
            return
        await self._h_mark_job_finished(
            job_id, cause=f"its driver at {addr[0]}:{addr[1]} is gone")

    async def _release_job(self, job_id):
        """What a finished job's driver owned goes with it (reference:
        Ray's owner fate-sharing): the non-detached actors it created, the
        non-detached actors those created, and so on, are killed, and the
        non-detached placement groups any of them created are removed, so
        that a GPU they held returns to the cluster. An actor that a
        detached actor created (a Serve replica, made by the detached
        controller) is not the driver's, whatever job it runs under."""
        job = self.jobs.get(job_id) or {}
        if not job.get("driver_addr"):
            return
        owners = {tuple(job["driver_addr"])}
        doomed = []
        grew = True
        while grew:
            grew = False
            for actor_id, a in self.actors.items():
                spec = a["spec"]
                if (actor_id in doomed or a["state"] == DEAD
                        or spec.is_detached or spec.owner_addr is None
                        or tuple(spec.owner_addr) not in owners):
                    continue
                doomed.append(actor_id)
                if a["addr"] is not None:
                    owners.add(tuple(a["addr"]))
                grew = True
        for actor_id in doomed:
            await self._h_kill_actor(actor_id, no_restart=True)
        for pg_id, pg in list(self.placement_groups.items()):
            if (pg["state"] != "REMOVED" and not pg.get("detached")
                    and pg.get("owner_addr") in owners):
                await self._h_remove_placement_group(pg_id)

    def _client_for_node(self, node_id) -> Optional[RpcClient]:
        info = self.nodes.get(node_id)
        if info is None or info["state"] == DEAD:
            return None
        if node_id not in self._node_clients:
            host, port = info["addr"]
            self._node_clients[node_id] = RpcClient(host, port)
        return self._node_clients[node_id]

    # --------------------------------------------------------------------- kv
    def _mark_dirty(self) -> None:
        self._snapshot_dirty = True

    async def _h_kv_put(self, namespace, key, value, overwrite=True):
        self._mark_dirty()
        ns = self.kv[namespace]
        if not overwrite and key in ns:
            return False
        ns[key] = value
        return True

    async def _h_kv_get(self, namespace, key):
        return self.kv[namespace].get(key)

    async def _h_kv_del(self, namespace, key):
        self._mark_dirty()
        return self.kv[namespace].pop(key, None) is not None

    async def _h_kv_keys(self, namespace, prefix=""):
        return [k for k in self.kv[namespace] if k.startswith(prefix)]

    async def _h_kv_exists(self, namespace, key):
        return key in self.kv[namespace]

    # ------------------------------------------------------------------ actors
    async def _h_register_actor(self, spec):
        """spec: pickled TaskSpec for the actor-creation task."""
        actor_id = spec.actor_id.binary()
        if actor_id in self.actors:
            # Duplicate delivery (client retried after a lost reply):
            # the first registration stands.
            return {"ok": True}
        name_key = (spec.actor_name, spec.namespace)
        if spec.actor_name:
            existing = self.named_actors.get(name_key)
            if existing is not None and self.actors[existing]["state"] != DEAD:
                return {"error": f"actor name {spec.actor_name!r} already taken",
                        "existing_actor_id": existing}
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "spec": spec,
            "state": PENDING_CREATION,
            "node_id": None,
            "addr": None,
            "worker_id": None,
            "restarts_used": 0,
            "name": spec.actor_name,
            "namespace": spec.namespace,
            "death_cause": None,
            "class_name": spec.function.qualname,
        }
        if spec.actor_name:
            self.named_actors[name_key] = actor_id
        self._actor_events[actor_id] = asyncio.Event()
        self._snapshot_dirty = True
        spawn_task(self._schedule_actor(actor_id))
        return {"ok": True}

    async def _h_register_actors(self, specs):
        """Batched registration: one round-trip for a whole fleet/gang
        bring-up.  A 500-actor storm previously paid 500 serialized RPC
        round-trips before the first worker lease went out; here every
        spec is admitted (and its scheduling task spawned) in one call.
        Replies are positional — one dict per spec, same contract as
        ``register_actor``."""
        return [await self._h_register_actor(spec) for spec in specs]

    async def _schedule_actor(self, actor_id):
        try:
            await self._place_actor(actor_id)
        finally:
            self._actor_demands.pop(actor_id, None)

    def _warn_actor_pending(self, actor_id, spec) -> None:
        if actor_id in self._actors_warned_pending:
            return
        self._actors_warned_pending.add(actor_id)
        self._record_event(
            "ACTOR_PENDING",
            f"actor {actor_id.hex()} demands {spec.resources.to_dict()}, "
            f"which no live node can fit; it waits past its "
            f"{GlobalConfig.worker_lease_timeout_ms} ms lease deadline "
            f"for the node a running autoscaler is adding",
            actor_id=actor_id.hex(), demand=spec.resources.to_dict())

    async def _place_actor(self, actor_id):
        from ray_tpu_torch._private.rpc import debug_log

        _dbg = debug_log(f"sched {actor_id.hex()[:6]}")
        a = self.actors[actor_id]
        spec = a["spec"]
        delay = 0.05
        deadline = time.monotonic() + GlobalConfig.worker_lease_timeout_ms / 1000
        while True:
            if a["state"] == DEAD:
                # kill() (or a node-death handler) resolved this actor
                # while it was pending — stop scheduling; never lease a
                # worker for a dead actor.
                return
            if time.monotonic() >= deadline:
                # Reference semantics: a FEASIBLE actor queues until
                # resources/worker slots free up (a 500-actor burst takes
                # minutes of worker spawns on a small host — that is
                # backlog, not failure). Only die when no node could ever
                # fit the demand.
                from ray_tpu_torch._private.scheduling_policy import (
                    is_feasible_anywhere,
                )

                if spec.scheduling.kind == "PLACEMENT_GROUP":
                    pg = self.placement_groups.get(
                        spec.scheduling.placement_group_id)
                    if pg is None or pg.get("state") == "REMOVED":
                        break  # the PG is gone: this can never schedule
                if is_feasible_anywhere(self.view, spec.resources):
                    deadline = (time.monotonic()
                                + GlobalConfig.worker_lease_timeout_ms
                                / 1000)
                elif (actor_id in self._actor_demands
                      and self._autoscaler_running()):
                    # No live node fits it, but a running autoscaler
                    # reads its demand: it waits for the node being
                    # added, as Ray keeps such an actor pending, and
                    # warns once.
                    self._warn_actor_pending(actor_id, spec)
                    deadline = (time.monotonic()
                                + GlobalConfig.worker_lease_timeout_ms
                                / 1000)
                else:
                    break
            pg_res = None
            if spec.scheduling.kind == "PLACEMENT_GROUP":
                pg_res = self._pg_demand(spec.scheduling, spec.resources)
                if pg_res is None:
                    await asyncio.sleep(delay)
                    continue
            node_id = pick_node(self.view, spec.resources, spec.scheduling,
                                None, pg_res)
            if node_id is None:
                if pg_res is None:
                    self._actor_demands[actor_id] = spec.resources.to_dict()
                await asyncio.sleep(delay)
                delay = min(delay * 1.5, 1.0)
                continue
            self._actor_demands.pop(actor_id, None)
            client = self._client_for_node(node_id)
            _dbg("picked node", node_id.hex()[:6] if hasattr(node_id, 'hex') else node_id, "client", client is not None)
            if client is None:
                # view said schedulable but the node is gone/DEAD: the two
                # structures can lag during node death. MUST yield — a bare
                # continue here busy-spins the whole GCS event loop.
                self.view.remove_node(node_id)
                await asyncio.sleep(delay)
                delay = min(delay * 1.5, 1.0)
                continue
            try:
                reply = await client.acall(
                    "lease_worker_for_actor", spec=spec,
                    demand=(pg_res or spec.resources).to_dict(),
                    timeout=60)
                _dbg("lease reply", reply)
            except Exception as exc:
                _dbg("lease EXC", repr(exc))
                await asyncio.sleep(delay)
                continue
            if not reply.get("ok"):
                if reply.get("env_setup_error"):
                    # Creation can never succeed on this env; retrying just
                    # re-runs a failing pip install every cycle.
                    a["state"] = DEAD
                    a["death_cause"] = (
                        f"runtime_env setup failed: "
                        f"{reply['env_setup_error']}")
                    self._actor_events[actor_id].set()
                    self.pubsub.publish("actor", {
                        "actor_id": actor_id, "state": DEAD,
                        "cause": a["death_cause"]})
                    return
                await asyncio.sleep(delay)
                continue
            # Worker is up and dedicated; tell it to become the actor.
            worker_addr = reply["worker_addr"]
            worker_id = reply["worker_id"]
            wclient = RpcClient(*worker_addr)
            try:
                _dbg("create_actor ->", worker_addr)
                result = await wclient.acall("create_actor", spec=spec,
                                             gpu_ids=reply.get("gpu_ids", []),
                                             timeout=120)
                _dbg("create_actor reply", result)
            except Exception as exc:
                _dbg("create EXC", repr(exc))
                wclient.close()
                await asyncio.sleep(delay)
                continue
            if not result.get("ok"):
                a["state"] = DEAD
                a["death_cause"] = result.get("error", "actor __init__ failed")
                self._actor_events[actor_id].set()
                self.pubsub.publish("actor", {"actor_id": actor_id,
                                              "state": DEAD,
                                              "cause": a["death_cause"]})
                wclient.close()
                return
            if a["state"] == DEAD:
                # kill() raced with creation: tear the new worker down.
                try:
                    await wclient.acall("kill_self", timeout=5)
                except Exception:
                    pass
                wclient.close()
                return
            a.update(state=ALIVE, node_id=node_id, addr=tuple(worker_addr),
                     worker_id=worker_id)
            self._actor_events[actor_id].set()
            self._actor_events[actor_id] = asyncio.Event()
            self.pubsub.publish("actor", {"actor_id": actor_id, "state": ALIVE,
                                          "addr": worker_addr})
            wclient.close()
            return
        a["state"] = DEAD
        a["death_cause"] = "failed to schedule actor (no feasible node)"
        self._actor_events[actor_id].set()

    def _pg_demand(self, sched: SchedulingStrategySpec,
                   demand: ResourceSet) -> Optional[ResourceSet]:
        """Rewrite demand onto bundle-formatted resources (reference trick:
        tasks in a PG consume `name_group_{index}_{pg_id}` resources)."""
        pg = self.placement_groups.get(sched.placement_group_id)
        if pg is None or pg["state"] != "CREATED":
            return None
        from ray_tpu_torch._private.resources import pg_task_demand

        return pg_task_demand(demand, sched.placement_group_id.hex(),
                              sched.bundle_index)

    async def _on_actor_failure(self, actor_id, cause):
        a = self.actors.get(actor_id)
        if a is None or a["state"] == DEAD:
            return
        spec = a["spec"]
        print(f"[gcs] actor {actor_id.hex()[:12]} failed "
              f"(restarts_used={a['restarts_used']}/{spec.max_restarts}): "
              f"{cause}", file=sys.stderr, flush=True)
        node_hex = (a.get("node_id") or b"").hex() or None
        if a["restarts_used"] < spec.max_restarts or spec.max_restarts == -1:
            a["restarts_used"] += 1
            a["state"] = RESTARTING
            a["addr"] = None
            self.pubsub.publish("actor", {"actor_id": actor_id,
                                          "state": RESTARTING})
            self._record_event(
                "ACTOR_RESTART",
                f"actor {actor_id.hex()[:12]} "
                f"({a.get('class_name', '')}) restarting "
                f"(restart {a['restarts_used']}/{spec.max_restarts}): "
                f"{cause}",
                node_id=node_hex, actor_id=actor_id.hex(), cause=str(cause))
            spawn_task(self._schedule_actor(actor_id))
        else:
            a["state"] = DEAD
            a["death_cause"] = cause
            self.pubsub.publish("actor", {"actor_id": actor_id, "state": DEAD,
                                          "cause": cause})
            intended = "killed via kill_actor" in str(cause)
            self._record_event(
                "ACTOR_DEATH",
                f"actor {actor_id.hex()[:12]} "
                f"({a.get('class_name', '')}) died: {cause}",
                # ray_tpu_torch.kill is user intent, not a failure to page on.
                severity="INFO" if intended else "ERROR",
                node_id=node_hex, actor_id=actor_id.hex(), cause=str(cause))
            self._actor_events.setdefault(actor_id, asyncio.Event()).set()
            name_key = (a["name"], a["namespace"])
            if a["name"] and self.named_actors.get(name_key) == actor_id:
                del self.named_actors[name_key]

    async def _h_report_actor_death(self, actor_id, cause, from_node=None):
        await self._on_actor_failure(actor_id, cause)
        return True

    async def _h_wait_actor_ready(self, actor_id, wait_timeout=60.0):
        deadline = time.monotonic() + wait_timeout
        while time.monotonic() < deadline:
            a = self.actors.get(actor_id)
            if a is None:
                return {"error": "unknown actor"}
            if a["state"] == ALIVE:
                return {"state": ALIVE, "addr": a["addr"]}
            if a["state"] == DEAD:
                return {"state": DEAD, "cause": a["death_cause"]}
            ev = self._actor_events.get(actor_id)
            try:
                await asyncio.wait_for(asyncio.shield(ev.wait()),
                                       max(deadline - time.monotonic(), 0.01))
            except asyncio.TimeoutError:
                pass
        return {"error": "timeout"}

    async def _h_get_actor_info(self, actor_id):
        a = self.actors.get(actor_id)
        if a is None:
            return None
        return {k: a[k] for k in
                ("actor_id", "state", "node_id", "addr", "worker_id", "name",
                 "namespace", "death_cause", "restarts_used", "class_name")}

    async def _h_get_named_actor(self, name, namespace):
        actor_id = self.named_actors.get((name, namespace))
        if actor_id is None:
            return None
        # A name lookup hands a handle to a process the creator's local GC
        # cannot see — pin against creator-side garbage collection.
        self.actors[actor_id]["pinned_by_lookup"] = True
        info = await self._h_get_actor_info(actor_id)
        if info is not None:
            info["spec"] = self.actors[actor_id]["spec"]
        return info

    async def _h_gc_actor(self, actor_id):
        """Creator-side handle GC; unlike kill_actor this is advisory — a
        lookup-pinned or detached actor survives it."""
        a = self.actors.get(actor_id)
        if a is None:
            return False
        if a.get("pinned_by_lookup") or a["spec"].is_detached:
            return False
        return await self._h_kill_actor(actor_id, no_restart=True)

    async def _h_list_named_actors(self, namespace=None):
        return [
            {"name": n, "namespace": ns, "actor_id": aid}
            for (n, ns), aid in self.named_actors.items()
            if namespace is None or ns == namespace
        ]

    async def _h_list_actors(self):
        return [await self._h_get_actor_info(aid) for aid in self.actors]

    async def _h_kill_actor(self, actor_id, no_restart=True):
        a = self.actors.get(actor_id)
        if a is None:
            return False
        if no_restart:
            a["spec"].max_restarts = 0
        if a["addr"] is not None:
            client = RpcClient(*a["addr"])
            try:
                await client.acall("kill_self", timeout=5)
            except Exception:
                pass
            client.close()
        await self._on_actor_failure(actor_id, "killed via kill_actor")
        return True

    # ------------------------------------------------------- placement groups
    async def _h_create_placement_group(self, pg_id, bundles, strategy, name="",
                                        lifetime=None, owner_addr=None):
        """2-phase commit against raylets (reference:
        `gcs_placement_group_scheduler.h`, raylet PrepareBundles/CommitBundles
        at `placement_group_resource_manager.h:54-61`). A group that is not
        ``lifetime="detached"`` ends with the driver that owns it, directly
        or through its actors (``owner_addr``, its creator's address)."""
        if pg_id in self.placement_groups:
            return True    # duplicate delivery: first creation stands
        self.placement_groups[pg_id] = {
            "pg_id": pg_id, "bundles": bundles, "strategy": strategy,
            "name": name, "state": "PENDING", "bundle_nodes": [None] * len(bundles),
            "detached": lifetime == "detached",
            "owner_addr": tuple(owner_addr) if owner_addr else None,
        }
        spawn_task(self._schedule_pg(pg_id))
        return True

    async def _schedule_pg(self, pg_id):
        pg = self.placement_groups[pg_id]
        bundles = [ResourceSet(b) for b in pg["bundles"]]
        strategy = pg["strategy"]
        deadline = time.monotonic() + GlobalConfig.worker_lease_timeout_ms / 1000
        while time.monotonic() < deadline and pg["state"] == "PENDING":
            placement = self._plan_pg(bundles, strategy)
            if placement is None:
                await asyncio.sleep(0.1)
                continue
            # Phase 1: prepare all bundles.
            prepared = []
            ok = True
            for idx, node_id in enumerate(placement):
                client = self._client_for_node(node_id)
                if client is None:
                    ok = False
                    break
                try:
                    r = await client.acall(
                        "prepare_bundle", pg_id=pg_id, bundle_index=idx,
                        resources=bundles[idx].to_dict(), timeout=30)
                    if not r:
                        ok = False
                        break
                    prepared.append((idx, node_id))
                except Exception:
                    ok = False
                    break
            if not ok:
                for idx, node_id in prepared:
                    client = self._client_for_node(node_id)
                    if client:
                        try:
                            await client.acall("return_bundle", pg_id=pg_id,
                                               bundle_index=idx, timeout=10)
                        except Exception:
                            pass
                await asyncio.sleep(0.1)
                continue
            # Phase 2: commit.
            for idx, node_id in enumerate(placement):
                client = self._client_for_node(node_id)
                await client.acall("commit_bundle", pg_id=pg_id,
                                   bundle_index=idx, timeout=30)
            pg["bundle_nodes"] = list(placement)
            pg["state"] = "CREATED"
            self.pubsub.publish("pg", {"pg_id": pg_id, "state": "CREATED"})
            return
        if pg["state"] == "PENDING":
            pg["state"] = "INFEASIBLE"
            self.pubsub.publish("pg", {"pg_id": pg_id, "state": "INFEASIBLE"})

    def _plan_pg(self, bundles: List[ResourceSet], strategy: str
                 ) -> Optional[List[bytes]]:
        """Bin-pack bundles onto nodes honoring PACK/SPREAD/STRICT_*."""
        avail = {nid: ResourceSet(nr.available.to_dict())
                 for nid, nr in self.view.nodes.items()}
        if not avail:
            return None
        placement: List[Optional[bytes]] = [None] * len(bundles)
        order = sorted(avail.keys())

        def fits(nid, demand):
            return avail[nid].is_superset_of(demand)

        if strategy == "STRICT_PACK":
            for nid in order:
                total = ResourceSet({})
                for b in bundles:
                    total = total.add(b)
                if fits(nid, total):
                    return [nid] * len(bundles)
            return None

        if strategy == "STRICT_SPREAD":
            if len(bundles) > len(order):
                return None
            used = set()
            for i, b in enumerate(bundles):
                chosen = None
                for nid in order:
                    if nid not in used and fits(nid, b):
                        chosen = nid
                        break
                if chosen is None:
                    return None
                used.add(chosen)
                placement[i] = chosen
            return placement

        # PACK (best effort pack) / SPREAD (best effort spread)
        prefer_spread = strategy == "SPREAD"
        last = None
        for i, b in enumerate(bundles):
            candidates = [n for n in order if fits(n, b)]
            if not candidates:
                return None
            if prefer_spread:
                fresh = [n for n in candidates if n != last]
                chosen = (fresh or candidates)[0]
            else:
                chosen = candidates[0] if last is None or last not in candidates \
                    else last
            placement[i] = chosen
            avail[chosen] = avail[chosen].subtract(b)
            last = chosen
        return placement

    async def _h_remove_placement_group(self, pg_id):
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return False
        for idx, node_id in enumerate(pg["bundle_nodes"]):
            if node_id is None:
                continue
            client = self._client_for_node(node_id)
            if client is not None:
                try:
                    await client.acall("return_bundle", pg_id=pg_id,
                                       bundle_index=idx, timeout=10)
                except Exception:
                    pass
        pg["state"] = "REMOVED"
        return True

    async def _h_get_placement_group(self, pg_id):
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return None
        return {k: pg[k] for k in ("pg_id", "bundles", "strategy", "name",
                                   "state", "bundle_nodes")}

    async def _h_wait_placement_group_ready(self, pg_id, wait_timeout=60.0):
        deadline = time.monotonic() + wait_timeout
        while time.monotonic() < deadline:
            pg = self.placement_groups.get(pg_id)
            if pg is None:
                return {"error": "unknown placement group"}
            if pg["state"] in ("CREATED", "INFEASIBLE", "REMOVED"):
                return {"state": pg["state"]}
            await asyncio.sleep(0.02)
        return {"state": "PENDING"}

    async def _h_list_placement_groups(self):
        return [await self._h_get_placement_group(p)
                for p in self.placement_groups]

    # -------------------------------------------------------------------- jobs
    async def _h_next_job_id(self):
        self._next_job_int += 1
        return self._next_job_int

    async def _h_register_job(self, job_id, driver_addr, metadata=None):
        self._mark_dirty()
        self.jobs[job_id] = {"job_id": job_id, "driver_addr": driver_addr,
                             "metadata": metadata or {}, "state": "RUNNING",
                             "start_time": time.time()}
        self._record_event("JOB_STARTED",
                           f"job {job_id.hex()} registered by driver at "
                           f"{driver_addr[0]}:{driver_addr[1]}",
                           job_id=job_id.hex())
        return True

    async def _h_mark_job_finished(self, job_id, cause=None):
        self._mark_dirty()
        if job_id in self.jobs:
            self.jobs[job_id]["state"] = "FINISHED"
            self.jobs[job_id]["end_time"] = time.time()
            self._record_event("JOB_FINISHED",
                               f"job {job_id.hex()} finished"
                               + (f": {cause}" if cause else ""),
                               job_id=job_id.hex())
            # Not awaited: the driver's shutdown waits for this reply.
            spawn_task(self._release_job(job_id))
        return True

    async def _h_list_jobs(self):
        return list(self.jobs.values())

    async def _h_get_job_info(self, job_id):
        return self.jobs.get(job_id)

    # ------------------------------------------------------------------ pubsub
    async def _h_publish(self, channel, message):
        self.pubsub.publish(channel, message)
        return True

    async def _h_poll(self, channel, cursor, wait_timeout=10.0):
        return await self.pubsub.poll(channel, cursor, wait_timeout)

    async def _h_pubsub_seq(self):
        """Current global sequence — subscribe-from-now cursor for late
        joiners (a new driver must not replay old worker logs)."""
        return self.pubsub._seq

    # ------------------------------------------------------------- task events
    async def _h_push_task_events(self, events):
        self.task_events.extend(events)
        for e in events:
            self._task_event_counts[e.get("state", "UNKNOWN")] += 1
            # Trace-tagged spans additionally feed the tail-sampled
            # trace store (they stay in the ring for the timeline too).
            if e.get("state") == "SPAN" and e.get("trace_id"):
                self.trace_store.add_span(e)
        return True

    async def _h_get_task_events(self, job_id=None, limit=1000):
        out = [e for e in self.task_events
               if job_id is None or e.get("job_id") == job_id]
        return out[-limit:]

    # ------------------------------------------------------------------ traces
    async def _h_get_trace(self, trace_id):
        return self.trace_store.get(trace_id)

    async def _h_list_traces(self, limit=100):
        return self.trace_store.summaries(limit=limit)

    async def _h_trace_stats(self):
        return self.trace_store.stats()

    # ----------------------------------------------------------------- workers
    async def _h_register_worker(self, worker_id, info):
        self.workers[worker_id] = info
        return True

    async def _h_list_workers(self):
        return list(self.workers.values())

    # ------------------------------------------------------------------- misc
    async def _h_get_system_config(self):
        return GlobalConfig.dump_system_config()

    async def _h_cluster_resources(self):
        total = ResourceSet({})
        for nr in self.view.nodes.values():
            total = total.add(nr.total)
        return total.to_dict()

    async def _h_available_resources(self):
        total = ResourceSet({})
        for nr in self.view.nodes.values():
            total = total.add(nr.available)
        return total.to_dict()

    async def _h_internal_stats(self):
        return {"event_stats": self.server.stats.snapshot(),
                "num_nodes": len([n for n in self.nodes.values()
                                  if n["state"] == ALIVE]),
                "num_actors": len(self.actors)}


def main():
    # SIGUSR1 dumps all thread stacks to stderr (the daemon log) — the
    # first tool for a wedged control plane (reference: ray's SIGTERM
    # stack-dump handlers in util/logging).
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # SIGUSR2 dumps parked-coroutine stacks + submit-queue state for
    # every event loop — faulthandler can't see awaits (rpc.py).
    from ray_tpu_torch._private.rpc import install_coroutine_dump_signal
    install_coroutine_dump_signal()

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--system-config", default="{}")
    parser.add_argument("--fate-share-pid", type=int, default=0)
    # Identification only (lets `pkill -f <session-dir>` target one cluster).
    parser.add_argument("--session-dir", default="")
    args = parser.parse_args()

    GlobalConfig.load_system_config(args.system_config)
    from ray_tpu_torch._private.fate_share import watch_parent

    watch_parent(args.fate_share_pid)
    gcs = GcsServer(args.host, args.port)
    if args.session_dir:
        gcs.enable_snapshots(
            os.path.join(args.session_dir, "gcs_snapshot.pkl"))

        def _final_snapshot(*_):
            try:
                gcs._write_snapshot(gcs._build_snapshot())
            except Exception:
                pass
            os._exit(0)

        import signal

        signal.signal(signal.SIGTERM, _final_snapshot)
    port = gcs.start()
    metrics_port = gcs.start_metrics_http()
    # Parent discovers the ports from stdout.
    print(f"GCS_PORT={port}", flush=True)
    print(f"METRICS_PORT={metrics_port}", flush=True)
    import threading
    threading.Event().wait()


if __name__ == "__main__":
    main()
