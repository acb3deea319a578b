"""Dashboard head — aiohttp REST + HTML over GCS/raylet state.

Reference: `dashboard/head.py` (aiohttp head server), `dashboard/
state_aggregator.py` (GCS+raylet aggregation), `modules/metrics` (the
Prometheus endpoint). Runs as its own process per head node
(`python -m ray_tpu_torch.dashboard.head --gcs-host ... --gcs-port ...`);
the URL is registered in the GCS KV under "dashboard_url" so clients
and the CLI can find it.

The port's head is the reference's route for route; ``/api/programs``
reads the GCS program ring, whose rows on the card count the CUDA
programs (observability/xla.py). A job
submitted over HTTP carries its ``runtime_env`` as written; the head's
own client packages a local ``working_dir`` or ``py_modules`` entry
into the GCS, as a driver does. The head is started with
``CUDA_VISIBLE_DEVICES=""``: it never holds a card.

Endpoints:
  GET /               SPA client (hash-routed views, no build step;
                      `dashboard/client.py` — reference
                      `dashboard/client/src/App.tsx`)
  GET /api/cluster    resource totals/availability
  GET /api/nodes      nodes + per-raylet stats (workers, store, OOM)
  GET /api/actors     actor table
  GET /api/jobs       job table
  GET /api/tasks      recent task lifecycle events
  GET /api/timeline   Chrome-trace JSON download (chrome://tracing)
  GET /api/serve      live serving/JIT telemetry summary
  GET /api/rl         decoupled-RL rollup: acting vs learning
                      throughput, weight version/staleness, sample
                      queue depth, inference batching factor
  GET /api/train      training goodput & straggler rollup: per-worker
                      step matrix rows (?worker=, ?limit=), goodput
                      ratio + lost seconds by cause, per-phase means,
                      stall/straggler flags
  GET /api/accounting serve cost accounting & SLO attainment: top-N
                      tenants by chip-seconds (?top_n=), per-lane
                      attainment/burn, per-request cost rows
                      (?tenant=, ?lane=, ?trace_id=, ?limit=), and the
                      serve_tenant_*/serve_request_cost_* metric series
  GET /api/programs   program cost & roofline rollup (?fn=, ?verdict=,
                      ?limit=, ?top_n=) and the xla_program_* series
  GET /api/memory     per-node object-store introspection + spill metrics
  GET /api/data       data-pipeline (DatasetStats) metric summary
  GET /api/events     ClusterEventLog (failure forensics) with ?type=,
                      ?severity= (INFO/WARNING/ERROR), ?node=, ?limit=
                      filters. Registered event types: WORKER_EXIT,
                      ACTOR_DEATH, ACTOR_RESTART, NODE_ADDED,
                      NODE_REMOVED, LEASE_RECLAIMED, TASK_RETRY,
                      SPILL_PRESSURE, JOB_STARTED, JOB_FINISHED,
                      AUTOSCALE_UP, AUTOSCALE_DOWN, PREEMPT_RESCHEDULE,
                      BACKPRESSURE_ADJUST, TRAIN_STRAGGLER, TRAIN_STALL,
                      SLO_BURN, PERF_REGRESSION.
  GET /api/controller control-plane decision log (serve autoscaler,
                      data backpressure, memory preemption) with
                      ?controller=, ?action=, ?limit= filters; each row
                      carries the metric reading that triggered it
  GET /api/logs       per-task/actor/worker log retrieval: exactly one
                      of ?task_id=, ?actor_id=, ?worker_id= (hex), plus
                      ?tail=N (default 100)
  GET /api/stacks     cluster-wide all-thread Python stack dump (the
                      `ray stack` equivalent): ?node=<hex prefix>,
                      ?worker=<hex> narrow the fan-out
  GET /api/profile    on-demand wall-clock sampling profile of a node's
                      workers: ?node=, ?worker=, ?duration=, ?hz=;
                      ?format=speedscope merges every worker into one
                      speedscope JSON (threads namespaced by worker)
  GET /api/profile/stacks  single-node stack dump (legacy spelling of
                      /api/stacks with a ?node= scope)
  GET /metrics        Prometheus text (scrape target)
  POST /api/job_submissions, GET /api/job_submissions[/{sid}[/logs]],
  POST /api/job_submissions/{sid}/stop
                      job submission (``job_submission.JobSubmissionClient``
                      with an ``http://`` address)
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Any, Dict, List

from aiohttp import web

from ray_tpu_torch._private.rpc import RpcClient

from ray_tpu_torch.dashboard.client import HTML as _HTML


class DashboardHead:
    def __init__(self, gcs_host: str, gcs_port: int):
        self._gcs = RpcClient(gcs_host, gcs_port)
        self._gcs_addr = (gcs_host, gcs_port)
        self._job_client = None
        self._job_client_lock = __import__("threading").Lock()

    def _jobs_client(self):
        """Lazy embedded driver connection: job submission needs actor
        creation, so the dashboard becomes a (CPU-less) driver on first
        use (reference: job_head.py forwards to the JobManager's own
        core worker)."""
        with self._job_client_lock:
            if self._job_client is None:
                import ray_tpu_torch
                from ray_tpu_torch.job_submission import JobSubmissionClient

                ray_tpu_torch.init(address="%s:%d" % self._gcs_addr,
                             ignore_reinit_error=True)
                self._job_client = JobSubmissionClient()
            return self._job_client

    # ------------------------------------------------------------ handlers
    async def index(self, _req) -> web.Response:
        return web.Response(text=_HTML, content_type="text/html")

    async def cluster(self, _req) -> web.Response:
        total = await self._gcs.acall("cluster_resources", timeout=10)
        avail = await self._gcs.acall("available_resources", timeout=10)
        return web.json_response({"total": total, "available": avail})

    async def nodes(self, _req) -> web.Response:
        nodes = await self._gcs.acall("get_all_nodes", timeout=10)
        out: List[Dict[str, Any]] = []
        for n in nodes:
            row = {
                "node_id": n["node_id"].hex()[:12],
                "state": n["state"],
                "addr": f"{n['addr'][0]}:{n['addr'][1]}",
                "total": n.get("total", {}),
                "available": n.get("available", {}),
            }
            if n["state"] == "ALIVE":
                client = RpcClient(*tuple(n["addr"]))
                try:
                    st = await client.acall("node_stats", timeout=5)
                    row.update(workers=st.get("num_workers"),
                               oom_kills=st.get("oom_kills"),
                               store=st.get("store", {}))
                except Exception as e:
                    row["stats_error"] = str(e)
                finally:
                    client.close()
            out.append(row)
        return web.json_response(out)

    async def actors(self, _req) -> web.Response:
        actors = await self._gcs.acall("list_actors", timeout=10)
        out = []
        for a in actors or []:
            if a is None:
                continue
            aid = a.get("actor_id")
            out.append({
                "actor_id": aid.hex()[:12] if isinstance(aid, bytes)
                else str(aid),
                "class": a.get("class_name", ""),
                "state": a.get("state", ""),
                "name": a.get("name") or "",
                "restarts": a.get("restarts_used", 0),
            })
        return web.json_response(out)

    async def jobs(self, _req) -> web.Response:
        jobs = await self._gcs.acall("list_jobs", timeout=10)
        out = []
        for j in jobs or []:
            jid = j.get("job_id")
            out.append({
                "job_id": jid.hex() if isinstance(jid, bytes) else str(jid),
                "state": j.get("state", ""),
                "namespace": (j.get("metadata") or {}).get("namespace", ""),
            })
        return web.json_response(out)

    async def tasks(self, req) -> web.Response:
        limit = int(req.query.get("limit", 200))
        events = await self._gcs.acall("get_task_events", limit=limit,
                                       timeout=10)
        safe = []
        for e in events or []:
            safe.append({k: (v.hex() if isinstance(v, bytes) else v)
                         for k, v in e.items()})
        return web.json_response(safe)

    async def metrics(self, _req) -> web.Response:
        text = await self._gcs.acall("metrics_text", timeout=10)
        return web.Response(text=text, content_type="text/plain")

    async def traces(self, req) -> web.Response:
        """Kept-trace summaries plus TraceStore health counters."""
        limit = int(req.query.get("limit", 100))
        summaries = await self._gcs.acall("list_traces", limit=limit,
                                          timeout=10)
        stats = await self._gcs.acall("trace_stats", timeout=10)
        return web.json_response(
            {"traces": summaries or [], "stats": stats or {}},
            dumps=lambda o: json.dumps(o, default=str))

    async def trace(self, req) -> web.Response:
        """One request's assembled causal tree: /api/trace?trace_id=."""
        trace_id = req.query.get("trace_id")
        if not trace_id:
            return web.json_response(
                {"error": "trace_id query parameter required"},
                status=400)
        rec = await self._gcs.acall("get_trace", trace_id=trace_id,
                                    timeout=10)
        if rec is None:
            return web.json_response(
                {"error": f"no trace {trace_id}"}, status=404)
        from ray_tpu_torch.util.tracing import build_trace_tree, critical_path

        tree = build_trace_tree(rec.get("spans") or [])
        tree.update({"trace_id": trace_id,
                     "complete": bool(rec.get("complete")),
                     "dur": rec.get("dur"),
                     "error": rec.get("error", False),
                     "keep_reason": rec.get("keep_reason"),
                     "critical_path": critical_path(tree)})
        return web.json_response(
            tree, dumps=lambda o: json.dumps(o, default=str))

    async def timeline(self, req) -> web.Response:
        """Chrome-trace JSON of the task-event ring buffer — load in
        chrome://tracing or https://ui.perfetto.dev."""
        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch.observability.timeline import build_chrome_trace

        limit = int(req.query.get(
            "limit", GlobalConfig.task_events_buffer_size))
        events = await self._gcs.acall("get_task_events", limit=limit,
                                       timeout=30)
        trace = build_chrome_trace(events or [])
        resp = web.json_response(
            trace, dumps=lambda o: json.dumps(o, default=str))
        resp.headers["Content-Disposition"] = (
            'attachment; filename="timeline.json"')
        return resp

    async def serve_stats(self, _req) -> web.Response:
        """Live serving/JIT telemetry aggregated on the GCS (engine
        latency histograms, queue gauges, compile counters), plus an
        explicit paged-KV / prefix-cache / router rollup so the "is HBM
        or prefill the bottleneck?" question is one fetch away."""
        summary = await self._gcs.acall(
            "user_metrics_summary",
            prefixes=["serve_", "jit_", "device_"], timeout=10)
        summary = summary or {}

        def _total(name):
            entry = summary.get(name)
            if not entry or not entry.get("data"):
                return None
            return sum(float(v) for v in entry["data"].values())

        used, free = (_total("serve_kv_blocks_used"),
                      _total("serve_kv_blocks_free"))
        hits, misses = (_total("serve_prefix_cache_hits_total"),
                        _total("serve_prefix_cache_misses_total"))
        kv: Dict[str, Any] = {"blocks_used": used, "blocks_free": free}
        if used is not None and free is not None and (used + free):
            kv["utilization"] = used / (used + free)
        prefix: Dict[str, Any] = {
            "hits": hits, "misses": misses,
            "hit_tokens": _total("serve_prefix_cache_hit_tokens_total"),
            "evictions": _total("serve_prefix_cache_evictions_total"),
        }
        if hits is not None and misses is not None and (hits + misses):
            prefix["hit_rate"] = hits / (hits + misses)
        router_depth = summary.get("serve_router_queue_depth", {})
        summary["kv_cache"] = kv
        summary["prefix_cache"] = prefix
        summary["router"] = {
            "queue_depth": dict(router_depth.get("data", {})),
            "requests": dict(summary.get(
                "serve_router_requests_total", {}).get("data", {})),
            # Disagg pool split: series tagged (lane, pool) — how much
            # traffic each SLO lane sent down the two-hop path.
            "lane_requests": dict(summary.get(
                "serve_router_lane_requests_total", {}).get("data", {})),
        }
        # Disaggregated-serving rollup: KV migration volume between the
        # prefill and decode pools, per-lane queue pressure +
        # preemptions, and the speculative-decode acceptance ratio —
        # the "is prefill stealing decode slots?" playbook numbers
        # (PERF.md) in one fetch.
        spec_prop = _total("serve_spec_proposed_tokens_total")
        spec_acc = _total("serve_spec_accepted_tokens_total")
        disagg: Dict[str, Any] = {
            "kv_migrated_blocks": _total("serve_kv_migrated_blocks_total"),
            "kv_migrated_bytes": _total("serve_kv_migrated_bytes_total"),
            "lane_queue_depth": dict(summary.get(
                "serve_lane_queue_depth", {}).get("data", {})),
            "preemptions": dict(summary.get(
                "serve_preemptions_total", {}).get("data", {})),
            "spec_proposed": spec_prop,
            "spec_accepted": spec_acc,
        }
        if spec_prop:
            disagg["spec_accept_ratio"] = (spec_acc or 0.0) / spec_prop
        summary["disagg"] = disagg

        # KV memory hierarchy rollup: per-tier traffic + residency and
        # the cache-aware router's decision mix — the "is the cluster
        # re-prefilling what a peer already computed?" numbers (PERF.md)
        # in one fetch. Series are tagged; fold them per tag value.
        def _by_tag(name, key):
            entry = summary.get(name)
            if not entry or not entry.get("data"):
                return {}
            folded: Dict[str, float] = {}
            pat = key + '="'
            for labels, v in entry["data"].items():
                for part in labels.split(","):
                    if part.startswith(pat):
                        tag = part[len(pat):-1]
                        folded[tag] = folded.get(tag, 0.0) + float(v)
                        break
            return folded

        tier_hits = _by_tag("serve_prefix_tier_hits_total", "tier")
        tier_misses = _by_tag("serve_prefix_tier_misses_total", "tier")
        tiers: Dict[str, Any] = {
            "hits": tier_hits,
            "misses": tier_misses,
            "spills": _by_tag("serve_prefix_tier_spills_total", "tier"),
            "promotes": _by_tag(
                "serve_prefix_tier_promotes_total", "tier"),
            "bytes": _by_tag("serve_kv_tier_bytes", "tier"),
            "router_decisions": _by_tag(
                "serve_router_cache_decisions_total", "outcome"),
        }
        hit_rate = {}
        for t in tier_hits:
            n = tier_hits[t] + tier_misses.get(t, 0.0)
            if n:
                hit_rate[t] = tier_hits[t] / n
        if hit_rate:
            tiers["hit_rate"] = hit_rate
        # One router per app: report the WORST (oldest) live view, not
        # a meaningless sum across per-pid gauge series.
        ages = [float(v) for v in summary.get(
            "serve_router_index_age_seconds", {}).get(
                "data", {}).values()]
        if ages:
            tiers["index_age_s"] = max(ages)
        summary["kv_tiers"] = tiers
        return web.json_response(summary)

    async def rl_stats(self, _req) -> web.Response:
        """Decoupled-RL rollup: the "is acting or learning the
        bottleneck?" numbers in one fetch — env-step vs learner-sample
        throughput counters, the versioned weight channel's
        version/staleness gauges, sample-queue depth and backpressure,
        and the inference servers' achieved batching factor."""
        summary = await self._gcs.acall(
            "user_metrics_summary", prefixes=["rl_"], timeout=10)
        summary = summary or {}

        def _total(name):
            entry = summary.get(name)
            if not entry or not entry.get("data"):
                return None
            return sum(float(v) for v in entry["data"].values())

        def _max(name):
            entry = summary.get(name)
            if not entry or not entry.get("data"):
                return None
            return max(float(v) for v in entry["data"].values())

        requests, batches = (_total("rl_infer_requests_total"),
                             _total("rl_infer_batches_total"))
        rollup: Dict[str, Any] = {
            "env_steps": _total("rl_env_steps_total"),
            "samples": _total("rl_samples_total"),
            "weight_version": _max("rl_weight_version"),
            "weight_staleness": _max("rl_weight_staleness"),
            "sample_queue_depth": _total("rl_sample_queue_depth"),
            "backpressure_waits": _total("rl_backpressure_waits_total"),
            "dropped_stale": _total("rl_dropped_stale_total"),
        }
        if requests is not None and batches:
            rollup["infer_batching_factor"] = requests / batches
        summary["rollup"] = rollup
        return web.json_response(summary)

    async def train_stats(self, req) -> web.Response:
        """Training goodput & straggler page: the GCS cross-worker
        rollup (per-worker steps / stall / straggler flags, cluster
        goodput ratio, lost seconds by cause, per-phase means), the
        recent step-matrix rows (?worker= and ?limit= filter them), and
        the cluster-folded ``train_*`` metric series."""
        try:
            limit = int(req.query.get("limit", 50))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        summary = await self._gcs.acall("train_summary", timeout=10)
        rows = await self._gcs.acall(
            "list_train_steps", worker=req.query.get("worker"),
            limit=limit, timeout=10)
        metrics = await self._gcs.acall(
            "user_metrics_summary", prefixes=["train_"], timeout=10)
        return web.json_response({
            "summary": summary or {},
            "steps": rows or [],
            "metrics": metrics or {},
        })

    async def accounting(self, req) -> web.Response:
        """Serve cost accounting & SLO attainment: the GCS summary
        (top-N tenants by chip-seconds, per-lane SLO attainment/burn),
        recent per-request cost rows (?tenant=, ?lane=, ?trace_id= and
        ?limit= filter them), and the cluster-folded accounting metric
        series. ?trace_id= additionally surfaces that request's own
        cost row inside the summary (acceptance path for the
        x-trace-id a routed request returned)."""
        try:
            limit = int(req.query.get("limit", 50))
            top_n = int(req.query.get("top_n", 0)) or None
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        trace_id = req.query.get("trace_id")
        summary = await self._gcs.acall(
            "serve_accounting_summary", top_n=top_n, trace_id=trace_id,
            timeout=10)
        rows = await self._gcs.acall(
            "list_serve_accounting",
            tenant=req.query.get("tenant"),
            lane=req.query.get("lane"),
            trace_id=trace_id, limit=limit, timeout=10)
        metrics = await self._gcs.acall(
            "user_metrics_summary",
            prefixes=["serve_tenant_", "serve_request_cost_"],
            timeout=10)
        return web.json_response({
            "summary": summary or {},
            "requests": rows or [],
            "metrics": metrics or {},
        })

    async def programs(self, req) -> web.Response:
        """The program cost & roofline page: the fleet summary
        (``xla_summary``), the newest program rows (``list_xla_programs``,
        ``fn``/``verdict``/``limit`` filter them), and the cluster-folded
        ``xla_program_*`` metric series. Rows tagged ``measurement:
        "cpu"`` carry nominal-spec ratios: plumbing proof, not
        performance."""
        try:
            limit = int(req.query.get("limit", 50))
            top_n = int(req.query.get("top_n", 8))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        summary = await self._gcs.acall(
            "xla_summary", top_n=top_n, timeout=10)
        rows = await self._gcs.acall(
            "list_xla_programs", fn=req.query.get("fn"),
            verdict=req.query.get("verdict"), limit=limit, timeout=10)
        metrics = await self._gcs.acall(
            "user_metrics_summary", prefixes=["xla_program_"],
            timeout=10)
        return web.json_response({
            "summary": summary or {},
            "programs": rows or [],
            "metrics": metrics or {},
        })

    async def memory(self, req) -> web.Response:
        """Object-store memory introspection: live per-node snapshots
        straight from each raylet's store (same numbers
        ``ray_tpu_torch.util.state.memory_summary()`` renders) plus the
        cluster-folded ``object_store_*`` metric series (which survive
        node exit via GCS tombstone folding)."""
        top_n = int(req.query.get("top_n", 10))
        nodes = await self._gcs.acall("get_all_nodes", timeout=10)
        out: List[Dict[str, Any]] = []
        for n in nodes or []:
            if n["state"] != "ALIVE":
                continue
            row: Dict[str, Any] = {"node_id": n["node_id"].hex()[:12]}
            client = RpcClient(*tuple(n["addr"]))
            try:
                snap = await client.acall("memory_stats", top_n=top_n,
                                          timeout=10)
                row["store"] = snap.get("store", {})
                row["top_objects"] = snap.get("objects", [])[:top_n]
            except Exception as e:
                row["stats_error"] = str(e)
            finally:
                client.close()
            out.append(row)
        summary = await self._gcs.acall(
            "user_metrics_summary", prefixes=["object_store_"], timeout=10)
        return web.json_response({"nodes": out, "metrics": summary or {}})

    async def events(self, req) -> web.Response:
        """ClusterEventLog query surface (failure forensics): typed,
        severity-tagged events with type/severity/node filters."""
        try:
            limit = int(req.query.get("limit", 100))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        rows = await self._gcs.acall(
            "list_cluster_events",
            event_type=req.query.get("type"),
            severity=req.query.get("severity"),
            node_id=req.query.get("node"),
            limit=limit, timeout=10)
        return web.json_response(rows or [])

    async def controller(self, req) -> web.Response:
        """Why did the control plane act? The GCS decision ring, newest
        last — every autoscale/backpressure/preempt action with the
        triggering metric reading attached."""
        try:
            limit = int(req.query.get("limit", 100))
        except ValueError:
            return web.json_response({"error": "bad limit"}, status=400)
        rows = await self._gcs.acall(
            "list_ctrl_decisions",
            controller=req.query.get("controller"),
            action=req.query.get("action"),
            limit=limit, timeout=10)
        return web.json_response(rows or [])

    async def logs(self, req) -> web.Response:
        """Per-task / per-actor / per-worker log retrieval, resolved
        through the GCS and served by the owning raylet from the on-disk
        log files (so dead workers' logs remain retrievable)."""
        task_id = req.query.get("task_id")
        actor_id = req.query.get("actor_id")
        worker_id = req.query.get("worker_id")
        if sum(bool(s) for s in (task_id, actor_id, worker_id)) != 1:
            return web.json_response(
                {"error": "exactly one of task_id=, actor_id=, "
                          "worker_id= is required"}, status=400)
        try:
            tail = int(req.query.get("tail", 100))
        except ValueError:
            return web.json_response({"error": "bad tail"}, status=400)
        try:
            if actor_id:
                info = await self._gcs.acall(
                    "get_actor_info", actor_id=bytes.fromhex(actor_id),
                    timeout=10)
                if not info or not info.get("worker_id"):
                    return web.json_response(
                        {"error": f"actor {actor_id} not found or has "
                                  "no worker"}, status=404)
                worker_id = info["worker_id"].hex()
            if worker_id:
                node_hex = None
                for row in await self._gcs.acall("list_workers",
                                                 timeout=10):
                    if row["worker_id"].hex() == worker_id:
                        node_hex = row["node_id"].hex()
                        break
                if node_hex is None:
                    return web.json_response(
                        {"error": f"worker {worker_id} not found"},
                        status=404)
                client = await self._node_raylet(node_hex)
                if client is None:
                    return web.json_response(
                        {"error": f"node {node_hex[:12]} unreachable"},
                        status=404)
                try:
                    reply = await client.acall(
                        "get_log", worker_id=bytes.fromhex(worker_id),
                        tail=tail, timeout=15)
                finally:
                    client.close()
                return web.json_response(
                    {"lines": reply.get("lines", [])})
            # task_id: fan out to every alive node; the attribution
            # markers make non-owners return nothing.
            lines: List[str] = []
            nodes = await self._gcs.acall("get_all_nodes", timeout=10)
            for n in nodes or []:
                if n["state"] != "ALIVE":
                    continue
                client = RpcClient(*tuple(n["addr"]))
                try:
                    reply = await client.acall(
                        "get_log", task_id=task_id, tail=tail,
                        timeout=15)
                    lines.extend(reply.get("lines", []))
                except Exception:
                    pass
                finally:
                    client.close()
            if tail:
                lines = lines[-tail:]
            return web.json_response({"lines": lines})
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)

    async def data_stats(self, _req) -> web.Response:
        """Data-pipeline telemetry: per-stage ``data_*`` series (rows/
        bytes/blocks out, wall vs blocked time, in-flight tasks and queue
        depth) aggregated on the GCS."""
        summary = await self._gcs.acall(
            "user_metrics_summary", prefixes=["data_"], timeout=10)
        return web.json_response(summary or {})

    # ---- profiling (reference: dashboard/modules/reporter/
    # profile_manager.py — on-demand stack dump + sampling CPU profile
    # per worker, flamegraph-able folded-stack payloads) ----------------

    async def _node_raylet(self, node_prefix):
        nodes = await self._gcs.acall("get_all_nodes", timeout=10)
        for n in nodes or []:
            if n["state"] != "ALIVE":
                continue
            if (node_prefix is None
                    or n["node_id"].hex().startswith(node_prefix)):
                return RpcClient(*n["addr"])
        return None

    async def profile(self, req) -> web.Response:
        client = await self._node_raylet(req.query.get("node"))
        if client is None:
            return web.json_response({"error": "no such node"}, status=404)
        kind = ("stacks" if req.path.endswith("/stacks") else "profile")
        wid = req.query.get("worker")
        hz = req.query.get("hz")
        try:
            out = await client.acall(
                "profile_worker",
                worker_id=bytes.fromhex(wid) if wid else None,
                duration_s=float(req.query.get("duration", 5.0)),
                kind=kind, hz=float(hz) if hz else None, timeout=120)
        finally:
            client.close()
        if kind == "profile" and req.query.get("format") == "speedscope":
            # One merged speedscope document: every worker's threads,
            # namespaced `<worker8>:<thread>`, over a shared frame table.
            from ray_tpu_torch.observability import profiling as _profiling

            counts = {}
            for whex, rep in (out or {}).items():
                if isinstance(rep, dict):
                    _profiling.merge_counts(
                        counts, rep.get("counts") or {},
                        thread_prefix=f"{whex[:8]}:")
            return web.json_response(_profiling.render_speedscope(
                counts, name="ray_tpu_torch node profile"))
        return web.json_response(out)

    async def stacks(self, req) -> web.Response:
        """Cluster-wide stack dump: fan the raylet `dump_stacks` RPC out
        to every alive node (optionally scoped by ?node= / ?worker=) and
        merge the per-worker replies."""
        node_prefix = req.query.get("node")
        wid = req.query.get("worker")
        nodes = await self._gcs.acall("get_all_nodes", timeout=10)
        out: Dict[str, Any] = {}
        for n in nodes or []:
            if n["state"] != "ALIVE":
                continue
            if node_prefix and \
                    not n["node_id"].hex().startswith(node_prefix):
                continue
            client = RpcClient(*tuple(n["addr"]))
            try:
                reply = await client.acall(
                    "dump_stacks",
                    worker_id=bytes.fromhex(wid) if wid else None,
                    timeout=20)
                out.update(reply or {})
            except Exception as e:  # noqa: BLE001
                out[f"node-{n['node_id'].hex()[:12]}"] = {"error": str(e)}
            finally:
                client.close()
        return web.json_response(out)

    # ---- job submission REST (reference: dashboard/modules/job/job_head
    # .py — POST/GET/logs endpoints so off-cluster clients submit over
    # HTTP; SDK/CLI counterpart in job_submission.JobSubmissionClient
    # with an http:// address) ------------------------------------------

    async def submit_job(self, req) -> web.Response:
        body = await req.json()
        entrypoint = body.get("entrypoint")
        if not entrypoint:
            return web.json_response(
                {"error": "entrypoint is required"}, status=400)
        loop = asyncio.get_running_loop()

        def _go():
            return self._jobs_client().submit_job(
                entrypoint=entrypoint,
                submission_id=body.get("submission_id"),
                runtime_env=body.get("runtime_env"))

        try:
            sid = await loop.run_in_executor(None, _go)
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"submission_id": sid})

    async def list_job_submissions(self, _req) -> web.Response:
        loop = asyncio.get_running_loop()
        jobs = await loop.run_in_executor(
            None, lambda: self._jobs_client().list_jobs())
        return web.json_response(jobs)

    async def job_submission(self, req) -> web.Response:
        sid = req.match_info["sid"]
        loop = asyncio.get_running_loop()
        try:
            info = await loop.run_in_executor(
                None, lambda: self._jobs_client().get_job_info(sid))
        except KeyError:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response(info)

    async def job_submission_logs(self, req) -> web.Response:
        sid = req.match_info["sid"]
        loop = asyncio.get_running_loop()
        try:
            logs = await loop.run_in_executor(
                None, lambda: self._jobs_client().get_job_logs(sid))
        except KeyError:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response({"logs": logs})

    async def stop_job_submission(self, req) -> web.Response:
        sid = req.match_info["sid"]
        loop = asyncio.get_running_loop()
        try:
            stopped = await loop.run_in_executor(
                None, lambda: self._jobs_client().stop_job(sid))
        except KeyError:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response({"stopped": bool(stopped)})

    # --------------------------------------------------------------- serve
    def build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/", self.index)
        app.router.add_get("/api/cluster", self.cluster)
        app.router.add_get("/api/nodes", self.nodes)
        app.router.add_get("/api/actors", self.actors)
        app.router.add_get("/api/jobs", self.jobs)
        app.router.add_get("/api/tasks", self.tasks)
        app.router.add_get("/metrics", self.metrics)
        app.router.add_get("/api/timeline", self.timeline)
        app.router.add_get("/api/traces", self.traces)
        app.router.add_get("/api/trace", self.trace)
        app.router.add_get("/api/serve", self.serve_stats)
        app.router.add_get("/api/rl", self.rl_stats)
        app.router.add_get("/api/train", self.train_stats)
        app.router.add_get("/api/accounting", self.accounting)
        app.router.add_get("/api/programs", self.programs)
        app.router.add_get("/api/memory", self.memory)
        app.router.add_get("/api/data", self.data_stats)
        app.router.add_get("/api/events", self.events)
        app.router.add_get("/api/controller", self.controller)
        app.router.add_get("/api/logs", self.logs)
        app.router.add_get("/api/profile", self.profile)
        app.router.add_get("/api/profile/stacks", self.profile)
        app.router.add_get("/api/stacks", self.stacks)
        app.router.add_post("/api/job_submissions", self.submit_job)
        app.router.add_get("/api/job_submissions", self.list_job_submissions)
        app.router.add_get("/api/job_submissions/{sid}", self.job_submission)
        app.router.add_get("/api/job_submissions/{sid}/logs",
                           self.job_submission_logs)
        app.router.add_post("/api/job_submissions/{sid}/stop",
                            self.stop_job_submission)
        return app


async def _serve(head: DashboardHead, host: str, port: int) -> int:
    runner = web.AppRunner(head.build_app())
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    port = runner.addresses[0][1]
    # Register for discovery (CLI / clients read this KV key). Same event
    # loop as every other GCS call — RpcClient connections are loop-bound.
    try:
        await head._gcs.acall(
            "kv_put", namespace="dashboard", key="dashboard_url",
            value=f"http://{host}:{port}".encode(), timeout=10)
    except Exception:
        pass
    return port


def main() -> None:
    import os
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--fate-share-pid", type=int, default=0)
    # Identification only: puts the session dir on the command line so
    # `pkill -f <session_dir>` cleanup and humans can find the daemon
    # that belongs to a session.
    parser.add_argument("--session-dir", default="")
    args = parser.parse_args()

    if args.fate_share_pid:
        from ray_tpu_torch._private.fate_share import watch_parent

        watch_parent(args.fate_share_pid)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    head = DashboardHead(args.gcs_host, args.gcs_port)
    port = loop.run_until_complete(_serve(head, args.host, args.port))
    print(f"DASHBOARD_PORT={port}", flush=True)
    sys.stdout.flush()

    async def _gcs_watchdog():
        # The dashboard must never outlive its cluster: without this, a
        # no-fate-share start (`ray_tpu_torch start --head`) leaks the process
        # forever once the GCS goes away (observed as a cross-test daemon
        # leak). Tolerate brief GCS bounces; exit after sustained loss.
        misses = 0
        while True:
            await asyncio.sleep(5.0)
            try:
                await head._gcs.acall("get_all_nodes", timeout=5)
                misses = 0
            except Exception:
                misses += 1
                if misses >= 6:
                    sys.stderr.write(
                        "[dashboard] GCS unreachable for ~30s; exiting\n")
                    os._exit(0)

    from ray_tpu_torch._private.rpc import spawn_task

    spawn_task(_gcs_watchdog(), loop=loop)
    loop.run_forever()


if __name__ == "__main__":
    main()
