"""Raylet — the per-node daemon.

Role-equivalent to the reference's `src/ray/raylet/` NodeManager: hosts the
node's shared-memory object store (as plasma runs inside the raylet —
`object_manager.cc:32`), manages the warm worker pool
(`worker_pool.h:104` PopWorker), serves the worker-lease protocol with
hybrid-policy spillback (`node_manager.cc:1714` HandleRequestWorkerLease,
`cluster_task_manager.h:70`), performs placement-group bundle 2-phase-commit
(`placement_group_resource_manager.h:54-61`), transfers objects node-to-node
in chunks (`pull_manager.h:52`), and assigns GPU instances to leases so
workers can set `CUDA_VISIBLE_DEVICES` (``accelerators/gpu.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import NodeID, WorkerID
from ray_tpu_torch._private.object_store import NodeObjectStore
from ray_tpu_torch._private.resources import (
    CPU, GPU, MEM, OBJECT_STORE_MEM, NodeResources, ResourceSet,
)
from ray_tpu_torch._private.rpc import RpcClient, RpcServer, get_io_loop, spawn_task
from ray_tpu_torch._private.scheduling_policy import (
    ClusterView, is_feasible_anywhere, pick_node,
)


class _WorkerHandle:
    def __init__(self, worker_id: bytes, proc: subprocess.Popen,
                 addr: Tuple[str, int], job_id: bytes,
                 pool_key: Optional[bytes] = None,
                 runtime_env: Optional[Dict[str, Any]] = None):
        self.worker_id = worker_id
        self.proc = proc
        self.addr = addr
        self.job_id = job_id
        # Pool identity: (job, runtime-env hash) — reference worker_pool
        # keys cached workers the same way so a task never runs in another
        # env's worker.
        self.pool_key = pool_key if pool_key is not None else job_id
        self.runtime_env = runtime_env
        self.env_uris: list = []      # runtime_env cache entries in use
        self.out_path: Optional[str] = None   # stdout log file
        self.err_path: Optional[str] = None   # stderr log file
        self.lease: Optional[Dict[str, Any]] = None  # demand + gpu ids
        self.is_actor = False
        self.actor_id: Optional[bytes] = None
        # Bumped on every grant (task lease OR dedicated-actor lease).
        # return_worker must echo it back: a return processed late — a
        # slow raylet can apply a frame a minute after it was sent —
        # must not be able to strip a lease the worker acquired SINCE
        # (observed: a stale task-lease return re-offered a worker that
        # had become a dedicated ACTOR worker, and the next task-lease
        # failure path SIGKILLed the actor).
        self.lease_epoch = 0
        self.last_idle = time.monotonic()
        # Set when the worker registers (or dies before registering) —
        # the spawn throttle waits on this instead of polling.
        self.registered = asyncio.Event()


class Raylet:
    def __init__(self, node_id: bytes, host: str, gcs_addr: Tuple[str, int],
                 resources: Dict[str, float], labels: Dict[str, str],
                 session_dir: str, object_store_capacity: int,
                 port: int = 0):
        self.node_id = node_id
        self.host = host
        self.session_dir = session_dir
        self.gcs = RpcClient(*gcs_addr)
        self.gcs_addr = gcs_addr

        self.server = RpcServer(host, port)
        self._register_handlers()

        # --- resources ---
        self.labels = labels
        self.total = ResourceSet(resources)
        self.local = NodeResources(self.total, labels)
        # GPU instance pool for CUDA_VISIBLE_DEVICES assignment.
        n_gpu = int(resources.get(GPU, 0))
        self._free_gpus: List[int] = list(range(n_gpu))
        # GPU dedicated to fractional (<1 GPU) leases; refcounted so it is
        # never co-assigned to a whole-GPU lease.
        self._frac_gpu: Optional[int] = None
        self._frac_users = 0

        # --- cluster view (replicated from GCS heartbeats) ---
        self.view = ClusterView()
        self._node_addrs: Dict[bytes, Tuple[str, int]] = {}

        # --- object store ---
        shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else session_dir
        self.store = NodeObjectStore(
            object_store_capacity, shm_dir,
            os.path.join(session_dir, "spill", node_id.hex()[:12]),
            node_id.hex())

        # --- worker pool ---
        self.workers: Dict[bytes, _WorkerHandle] = {}
        # Keyed by pool_key = job_id (+ runtime-env hash when set).
        self._idle: Dict[bytes, deque] = defaultdict(deque)
        self._starting: Dict[bytes, int] = defaultdict(int)
        self._pending_pop: Dict[bytes, deque] = defaultdict(deque)
        self._max_workers = (GlobalConfig.max_workers_per_node
                             or max(int(resources.get(CPU, 1)), 1) * 4)

        # --- queued lease requests waiting for local resources ---
        self._lease_queue: deque = deque()
        self._lease_queue_event = asyncio.Event()
        # Demands recently rejected as infeasible-anywhere: the autoscaler's
        # scale-up signal (owners retry from their side, so these never sit
        # in _lease_queue). Deduped by shape — lease retries of one task
        # must not read as N distinct demands.
        self._unfulfilled: Dict[tuple, float] = {}

        # --- placement group bundles ---
        # (pg_id, idx) -> {"resources": ResourceSet, "committed": bool}
        self._bundles: Dict[Tuple[bytes, int], Dict[str, Any]] = {}

        self._remote_raylets: Dict[Tuple[str, int], RpcClient] = {}
        # client (worker_id) -> oids it holds arena mappings of; released
        # in bulk when the client process dies (plasma: per-client object
        # refs cleared on disconnect).
        self._client_mapped: Dict[bytes, Set[bytes]] = defaultdict(set)
        self._dead = False
        self._oom_kills = 0
        # worker_id -> True for workers the memory monitor shot; owners ask
        # via get_worker_exit_info to turn the crash into OutOfMemoryError.
        self._oom_killed: Set[bytes] = set()
        # Workers preemptively rescheduled by the memory monitor BELOW
        # the kill threshold: classified PREEMPT_RESCHEDULE (retriable —
        # the owner's normal crash-retry path reruns the task), never
        # OOM_KILLED, so the user sees a reschedule, not an error.
        self._preempts = 0
        self._preempted: Set[bytes] = set()
        self._last_preempt_ts = 0.0
        # Workers whose death THIS raylet caused on purpose (pool cap,
        # idle TTL, lease return, kill_worker, graceful worker_exiting):
        # the reaper classifies them INTENDED_EXIT instead of reading the
        # SIGKILL we sent as SYSTEM_ERROR.
        self._intended_exit: Set[bytes] = set()
        # worker_id -> exit forensics (taxonomy, exit code, last log
        # lines) captured at reap time; served via get_worker_exit_info
        # so owners enrich WorkerCrashedError/ActorDiedError messages.
        self._exit_info: Dict[bytes, Dict[str, Any]] = {}
        # Spill counter watermark for SPILL_PRESSURE events.
        self._spills_reported = 0
        self._worker_info_cache: Dict[bytes, Any] = {}
        # pool_key -> (message, ts) of the last runtime_env setup failure:
        # turned into a fast lease error so owners fail tasks with
        # RuntimeEnvSetupError instead of hot-looping spawn attempts.
        self._env_failures: Dict[bytes, Tuple[str, float]] = {}
        # worker_id -> RpcClient used by the memory monitor's busy probe.
        self._worker_probe_clients: Dict[bytes, Any] = {}
        # Killed/retired worker Popen handles awaiting reap (zombies
        # otherwise; see _retire_proc).
        self._dying: List[subprocess.Popen] = []

    # ------------------------------------------------------------------- boot
    def start(self) -> int:
        port = self.server.start()
        reply = self.gcs.call(
            "register_node", node_id=self.node_id,
            addr=(self.host, port),
            resources=self.total.to_dict(), labels=self.labels,
            object_store_capacity=self.store.capacity)
        GlobalConfig.load_system_config(reply["system_config"])
        self._apply_nodes_snapshot(reply["nodes"])
        io = get_io_loop()
        io.submit(self._heartbeat_loop())
        io.submit(self._reaper_loop())
        io.submit(self._lease_dispatch_loop())
        io.submit(self._log_monitor_loop())
        io.submit(self._memory_monitor_loop())
        io.submit(self._reporter_loop())
        io.submit(self._stall_watchdog())
        return port

    async def _stall_watchdog(self):
        """Log when this raylet's event loop stops turning (reference:
        instrumented_io_context's lag stats). A stalled loop silently
        breaks heartbeats, worker pings, and lease handling — the log
        line turns 'mystery mass worker death' into a diagnosis."""
        last = time.monotonic()
        while not self._dead:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            gap = now - last - 1.0
            if gap > 5.0:
                sys.stderr.write(
                    f"[raylet {self.node_id.hex()[:8]}] event loop "
                    f"stalled {gap:.1f}s (workers={len(self.workers)})\n")
                sys.stderr.flush()
            last = now

    def _register_handlers(self):
        s = self.server
        for name in [
            "request_worker_lease", "return_worker", "lease_worker_for_actor",
            "register_worker", "worker_exiting",
            "create_object", "seal_object", "put_object", "get_object",
            "contains_object",
            "delete_objects", "pin_object", "unpin_object", "read_chunk",
            "release_object", "release_objects",
            "object_info", "store_stats", "memory_stats",
            "prepare_bundle", "commit_bundle", "return_bundle",
            "kill_worker", "node_stats", "shutdown_node", "get_tasks_info",
            "profile_worker", "dump_stacks",
            "get_worker_exit_info", "runtime_env_stats", "get_log",
        ]:
            s.register(name, getattr(self, f"_h_{name}"))

    def _report_event(self, event_type: str, message: str,
                      severity: Optional[str] = None, **extra) -> None:
        """Fire-and-forget a typed event to the GCS ClusterEventLog."""
        if self._dead:
            return

        async def _send():
            try:
                await self.gcs.acall(
                    "report_cluster_event", event_type=event_type,
                    message=message, severity=severity,
                    node_id=self.node_id.hex(), extra=extra, timeout=10)
            except Exception:
                pass

        spawn_task(_send())

    # -------------------------------------------------------------- heartbeat
    async def _heartbeat_loop(self):
        from ray_tpu_torch._private.rpc import debug_log

        _dbg = debug_log("hb")
        # Resource reports drive spillback freshness, so they run much
        # faster than liveness needs (reference splits these the same way:
        # report_resources_period vs health check period).
        period = GlobalConfig.raylet_report_resources_period_ms / 1000
        have_seq = 0
        while not self._dead:
            try:
                now = time.monotonic()
                _dbg("send")
                pending = [item[0].to_dict()
                           for item in list(self._lease_queue)[:64]]
                for key, ts in list(self._unfulfilled.items()):
                    if now - ts >= 10.0:
                        del self._unfulfilled[key]
                    else:
                        pending.append(dict(key))
                reply = await self.gcs.acall(
                    "heartbeat", node_id=self.node_id,
                    available=self.local.available.to_dict(),
                    total=self.local.total.to_dict(),
                    pending_demands=pending,
                    num_workers=len(self.workers),
                    have_seq=have_seq,
                    timeout=10)
                _dbg("reply ok")
                if reply.get("unknown"):
                    # The GCS doesn't know us: it restarted (bounce) —
                    # re-register with our existing identity and keep all
                    # local state; leases/workers/objects are untouched
                    # (reference: NotifyGCSRestart -> re-register,
                    # node_manager.proto:366).
                    _dbg("gcs bounce detected; re-registering")
                    rereg = await self.gcs.acall(
                        "register_node", node_id=self.node_id,
                        addr=(self.host, self.server.port),
                        resources=self.local.total.to_dict(),
                        labels=self.labels,
                        object_store_capacity=self.store.capacity,
                        timeout=10)
                    if "nodes" in rereg:
                        self._apply_nodes_snapshot(rereg["nodes"])
                        have_seq = 0  # fresh GCS numbers from 1 again
                elif "nodes" in reply:
                    self._apply_nodes_snapshot(reply["nodes"])
                    have_seq = reply.get("seq", 0)
            except Exception as e:
                _dbg("EXC", repr(e))
            await asyncio.sleep(period)

    def _apply_nodes_snapshot(self, nodes):
        seen = set()
        for n in nodes:
            if n["state"] != "ALIVE":
                self.view.remove_node(n["node_id"])
                continue
            seen.add(n["node_id"])
            self._node_addrs[n["node_id"]] = tuple(n["addr"])
            if n["node_id"] == self.node_id:
                # Authoritative local view is self.local; skip.
                self.view.update_node(n["node_id"], self.local)
                continue
            nr = NodeResources(ResourceSet(n["total"]), n["labels"])
            nr.available = ResourceSet(n["available"])
            self.view.update_node(n["node_id"], nr)
        for node_id in list(self.view.nodes.keys()):
            if node_id not in seen and node_id != self.node_id:
                self.view.remove_node(node_id)

    # ------------------------------------------------------------ worker pool
    def _worker_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        # The node's routable address: workers bind/advertise their RPC
        # servers on it (not loopback) so cross-host owner RPCs, object
        # pulls, and collective rendezvous work on real clusters.
        env["RAY_TPU_NODE_IP"] = self.host
        # Every worker starts seeing no card, as Ray starts its non-GPU
        # workers: a GPU lease makes its cards visible before the task
        # body runs (accelerators.gpu.note_lease), and a worker that never
        # holds one can never create a CUDA context on a card it was not
        # leased.
        env["CUDA_VISIBLE_DEVICES"] = ""
        return env

    def _runtime_env_manager(self):
        if getattr(self, "_renv_manager", None) is None:
            from ray_tpu_torch.runtime_env.manager import RuntimeEnvManager

            self._renv_manager = RuntimeEnvManager(
                os.path.join(self.session_dir, "runtime_envs"), self.gcs)
        return self._renv_manager

    def _release_worker_env(self, handle) -> None:
        """Per-worker teardown at every removal site: runtime_env cache
        refs plus the memory monitor's probe client."""
        if handle is not None:
            client = self._worker_probe_clients.pop(handle.worker_id, None)
            if client is not None:
                try:
                    client.close()
                except Exception:
                    pass
        if handle is not None and handle.env_uris:
            uris, handle.env_uris = handle.env_uris, []
            try:
                self._runtime_env_manager().release(uris)
            except Exception:
                pass

    async def _h_runtime_env_stats(self):
        return self._runtime_env_manager().stats()

    @staticmethod
    def _pool_key(job_id: bytes, runtime_env: Optional[Dict[str, Any]],
                  gpu_ids: Optional[List[int]] = None) -> bytes:
        """The idle pool a worker goes back to: its job and runtime_env,
        and for a container env the cards its command names (a container
        worker is started with its lease's CUDA_VISIBLE_DEVICES)."""
        if not runtime_env:
            return job_id
        digest = hashlib.md5(json.dumps(
            runtime_env, sort_keys=True, default=str).encode()).digest()
        key = job_id + digest[:8]
        if gpu_ids and runtime_env.get("container"):
            key += b"|gpus=" + ",".join(map(str, gpu_ids)).encode()
        return key

    def _spawn_worker(self, job_id: bytes,
                      runtime_env: Optional[Dict[str, Any]] = None,
                      gpu_ids: Optional[List[int]] = None) -> None:
        pool_key = self._pool_key(job_id, runtime_env, gpu_ids)
        self._starting[pool_key] += 1
        spawn_task(self._spawn_worker_async(job_id, runtime_env, pool_key,
                                            gpu_ids))

    async def _spawn_worker_async(self, job_id: bytes,
                                  runtime_env: Optional[Dict[str, Any]],
                                  pool_key: bytes,
                                  gpu_ids: Optional[List[int]] = None
                                  ) -> None:
        """Fork/exec OFF the event loop: Popen of this process takes
        ~100ms+, and a replenish burst of spawns on the
        loop thread stalls heartbeats long enough for the GCS to declare
        this node dead (observed: actor churn → 5s+ gap → node DEAD).

        Startup concurrency is throttled per node (reference:
        maximum_startup_concurrency = num_cpus): an unthrottled 500-actor
        burst boots hundreds of Python processes at once, starving every
        daemon's heartbeat on a small host — nodes get declared dead at
        exactly the moment they're busiest."""
        await self._spawn_worker_throttled(job_id, runtime_env, pool_key,
                                           gpu_ids)

    def _startup_sema(self) -> asyncio.Semaphore:
        if not hasattr(self, "_spawn_sema"):
            from ray_tpu_torch._private.resources import CPU as _CPU

            self._spawn_sema = asyncio.Semaphore(
                max(2, int(self.local.total.get(_CPU) or 2)))
        return self._spawn_sema

    async def _spawn_worker_throttled(self, job_id: bytes,
                                      runtime_env: Optional[Dict[str, Any]],
                                      pool_key: bytes,
                                      gpu_ids: Optional[List[int]] = None
                                      ) -> None:
        log_dir = os.path.join(self.session_dir, "logs")
        worker_id = WorkerID.from_random()
        out_path = os.path.join(
            log_dir, f"worker-{worker_id.hex()[:12]}.out")
        err_path = os.path.join(
            log_dir, f"worker-{worker_id.hex()[:12]}.err")

        def _open_logs():
            # Sync file I/O belongs off the loop: on a loaded node (or a
            # network-backed session dir) mkdir/open stall for ms-class
            # latencies, and this coroutine shares its loop with lease
            # dispatch and heartbeats.
            os.makedirs(log_dir, exist_ok=True)
            out = open(out_path, "wb")
            # Separate stderr stream: tracebacks must reach the driver
            # tagged as stderr (and survive for exit forensics) instead
            # of being interleaved into stdout.
            err = open(err_path, "wb")
            return out, err

        out, err = await asyncio.get_running_loop().run_in_executor(
            None, _open_logs)
        env = self._worker_env()
        env_uris = []
        python_exe = sys.executable
        if runtime_env:
            # Applied at worker spawn (reference: RuntimeEnvContext.exec_worker
            # runs the worker inside the env) — not mutated per-task. The
            # manager materializes pip venvs / code packages on pool miss.
            try:
                ctx = await self._runtime_env_manager().setup(runtime_env)
            except Exception as e:
                out.close()
                err.close()
                self._starting[pool_key] = max(
                    0, self._starting[pool_key] - 1)
                sys.stderr.write(f"[raylet] runtime_env setup failed: {e}\n")
                self._env_failures[self._pool_key(job_id, runtime_env)] = (
                    f"{type(e).__name__}: {e}", time.monotonic())
                waiters = self._pending_pop[pool_key]
                while waiters:
                    fut = waiters.popleft()
                    if not fut.done():
                        fut.set_result(None)
                        break
                return
            for key, val in ctx.env_vars.items():
                env[str(key)] = str(val)
            # The env's variables cannot make a card visible: a GPU lease
            # stays the only thing that does (see _worker_env).
            env["CUDA_VISIBLE_DEVICES"] = ""
            if ctx.working_dir:
                env["RAY_TPU_WORKING_DIR"] = ctx.working_dir
            if ctx.pythonpath:
                env["PYTHONPATH"] = os.pathsep.join(
                    ctx.pythonpath
                    + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
            if ctx.py_executable:
                python_exe = ctx.py_executable
                # The venv interpreter must still import ray_tpu_torch
                # itself.
                repo_root = os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))))
                path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p]
                if repo_root not in path:
                    env["PYTHONPATH"] = os.pathsep.join(path + [repo_root])
            env_uris = list(ctx.uris)
            command_prefix, python_exe = self._container_command(
                ctx, env, python_exe, gpu_ids)
        else:
            command_prefix = []
        cmd = command_prefix + [
               python_exe, "-m", "ray_tpu_torch._private.worker_main",
               "--raylet-host", self.host,
               "--raylet-port", str(self.server.port),
               "--gcs-host", self.gcs_addr[0],
               "--gcs-port", str(self.gcs_addr[1]),
               "--node-id", self.node_id.hex(),
               "--worker-id", worker_id.hex(),
               "--job-id", job_id.hex(),
               "--raylet-pid", str(os.getpid()),
               "--session-dir", self.session_dir]
        loop = asyncio.get_running_loop()
        # The concurrency slot covers ONLY fork + interpreter boot — not
        # runtime_env setup above (a cold pip install holding a slot
        # would head-of-line block every plain spawn on the node).
        async with self._startup_sema():
            try:
                proc = await loop.run_in_executor(
                    None, lambda: subprocess.Popen(
                        cmd, stdout=out, stderr=err, env=env,
                        start_new_session=True))
            except Exception as e:
                err.close()
                return self._spawn_failed(e, out, pool_key, env_uris)
            # The child holds its own copies of the log fds now.
            out.close()
            err.close()
            # Handle is completed when the worker registers back.
            handle = _WorkerHandle(worker_id.binary(), proc, ("", 0),
                                   job_id, pool_key=pool_key,
                                   runtime_env=runtime_env)
            handle.env_uris = env_uris
            handle.out_path = out_path
            handle.err_path = err_path
            self.workers[worker_id.binary()] = handle
            # Hold the startup-concurrency slot until the worker
            # REGISTERS: the expensive part of a spawn is the Python
            # boot, not the fork. Bounded so a crashed boot frees the
            # slot (the reaper also sets the event on death).
            try:
                await asyncio.wait_for(handle.registered.wait(), 30)
            except asyncio.TimeoutError:
                pass
        return None

    @staticmethod
    def _container_command(ctx, env: Dict[str, str], python_exe: str,
                           gpu_ids: Optional[List[int]]):
        """(command prefix, interpreter) of a worker spawn. In a container
        env the Popen env applies to the container CLI, not inside the
        container: the worker's env goes in through -e flags before the
        image, with CUDA_VISIBLE_DEVICES naming the lease's cards (none
        without a GPU lease), and the image's own python3 runs it (the
        reference's spawn, plus the card rule)."""
        prefix = list(ctx.command_prefix)
        if not prefix:
            return [], python_exe
        passthrough = dict(ctx.env_vars)
        for k in ("PYTHONPATH", "RAY_TPU_NODE_ID", "RAY_TPU_NODE_IP",
                  "RAY_TPU_WORKING_DIR"):
            if env.get(k):
                passthrough[k] = env[k]
        passthrough["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(i) for i in gpu_ids or [])
        flags = []
        for k, v in passthrough.items():
            flags += ["-e", f"{k}={v}"]
        return prefix[:-1] + flags + prefix[-1:], "python3"

    def _spawn_failed(self, e, out, pool_key, env_uris) -> None:
        """Popen failure cleanup: undo the _starting slot, return env
        cache refs, and fail one parked lease waiter fast instead of
        letting it ride out the full pop timeout."""
        out.close()
        self._starting[pool_key] = max(0, self._starting[pool_key] - 1)
        sys.stderr.write(f"[raylet] worker spawn failed: {e}\n")
        if env_uris:
            try:
                self._runtime_env_manager().release(env_uris)
            except Exception:
                pass
        waiters = self._pending_pop[pool_key]
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                break

    async def _h_register_worker(self, worker_id, port, pid, job_id):
        handle = self.workers.get(worker_id)
        if handle is None:
            return {"ok": False}
        handle.addr = (self.host, port)
        handle.registered.set()
        key = handle.pool_key
        self._env_failures.pop(key, None)
        self._starting[key] = max(0, self._starting[key] - 1)
        self._offer_worker(handle)
        return {"ok": True, "system_config": GlobalConfig.dump_system_config()}

    def _offer_worker(self, handle: _WorkerHandle):
        waiters = self._pending_pop[handle.pool_key]
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(handle)
                return
        # Pool hard cap: beyond max_workers idle processes per pool,
        # retire instead of hoarding — an idle worker is ~150 MB RSS
        # plus a heartbeat loop, and churn-heavy workloads otherwise
        # accumulate them without bound.
        if len(self._idle[handle.pool_key]) >= self._max_workers:
            self.workers.pop(handle.worker_id, None)
            self._release_worker_env(handle)
            self._intended_exit.add(handle.worker_id)
            try:
                self._retire_proc(handle.proc)
            except Exception:
                pass
            return
        handle.last_idle = time.monotonic()
        self._idle[handle.pool_key].append(handle)

    def _maybe_replenish(self, job_id: bytes,
                         runtime_env: Optional[Dict[str, Any]] = None
                         ) -> None:
        """Keep a floor of warm workers so the next actor creation (e.g.
        tune trials launched after kills) never serializes on a Python
        cold start."""
        pool_key = self._pool_key(job_id, runtime_env)
        # Workers still starting but already promised to waiting pops are
        # not warm capacity.
        warm = (len(self._idle[pool_key]) + self._starting[pool_key]
                - len(self._pending_pop[pool_key]))
        n_live = sum(1 for w in self.workers.values()
                     if w.job_id == job_id)
        want = GlobalConfig.worker_pool_min_idle
        while warm < want and n_live < self._max_workers:
            self._spawn_worker(job_id, runtime_env)
            warm += 1
            n_live += 1

    async def _pop_worker(self, job_id: bytes,
                          runtime_env: Optional[Dict[str, Any]] = None,
                          timeout: float = 60.0,
                          dedicated: bool = False,
                          gpu_ids: Optional[List[int]] = None
                          ) -> Optional[_WorkerHandle]:
        pool_key = self._pool_key(job_id, runtime_env, gpu_ids)
        # A container worker named with its cards is started per device
        # set: no warm floor of them is kept.
        replenish = pool_key == self._pool_key(job_id, runtime_env)
        idle = self._idle[pool_key]
        while idle:
            handle = idle.popleft()
            if handle.proc.poll() is None:
                if replenish:
                    self._maybe_replenish(job_id, runtime_env)
                return handle
            self.workers.pop(handle.worker_id, None)
            self._release_worker_env(handle)
        # Count async-starting workers too: they only land in self.workers
        # after the off-loop Popen, so without _starting a request burst in
        # that window would overshoot the cap.
        n_live = sum(1 for w in self.workers.values()
                     if w.job_id == job_id)
        n_live += sum(v for k, v in self._starting.items()
                      if k[:len(job_id)] == job_id)
        if dedicated or n_live < self._max_workers:
            # Dedicated (actor) workers are admission-controlled by the
            # resource allocation that already succeeded, not by the
            # pooled-task-worker cap: 500 fractional-CPU actors on a
            # 2-CPU node are legal, and capping them at CPU*4 workers
            # wedges every actor past the cap in PENDING_CREATION.
            # Python worker cold-start is expensive; prestart a batch on first
            # demand so bursts don't serialize on process spawn (reference:
            # worker pool prestart, `worker_pool.cc`).
            n_spawn = 1
            if n_live == 0 and not runtime_env:
                n_spawn = min(GlobalConfig.worker_startup_batch,
                              self._max_workers)
            for _ in range(n_spawn):
                self._spawn_worker(job_id, runtime_env, gpu_ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending_pop[pool_key].append(fut)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None

    def _sweep_idle_ttl(self) -> None:
        """Enforce worker_pool_idle_ttl_s: pooled workers idle past the
        TTL are killed down to the warm floor. Without this, phase
        churn accumulates workers without bound (observed: 893 live
        worker processes after an actor storm — each one's idle
        heartbeat loop then taxes the whole host)."""
        ttl = GlobalConfig.worker_pool_idle_ttl_s
        if ttl <= 0:
            return
        now = time.monotonic()
        floor = GlobalConfig.worker_pool_min_idle
        for pool_key, idle in list(self._idle.items()):
            while len(idle) > floor and now - idle[0].last_idle > ttl:
                handle = idle.popleft()
                self.workers.pop(handle.worker_id, None)
                self._release_worker_env(handle)
                self._intended_exit.add(handle.worker_id)
                try:
                    self._retire_proc(handle.proc)
                except Exception:
                    pass

    def _retire_proc(self, proc) -> None:
        """Kill (if alive) and queue for reaping. Every removal path
        must route here: a kill() without a later wait() leaves a ZOMBIE
        child, and a 10^3-actor storm was observed to stack ~800 of them
        under the raylets (eventual PID exhaustion)."""
        try:
            if proc.poll() is None:
                proc.kill()
        except Exception:
            pass
        self._dying.append(proc)

    def _reap_dying(self) -> None:
        still = []
        for proc in self._dying:
            try:
                if proc.poll() is None:
                    still.append(proc)
            except Exception:
                pass
        self._dying = still

    def _classify_exit(self, worker_id: bytes, handle, code) -> Dict[str, Any]:
        """Waitpid-status exit taxonomy + last-K log line capture, cached
        for get_worker_exit_info (reference: WorkerExitType plumbing in
        worker-failure RPCs)."""
        from ray_tpu_torch._private.log_monitor import tail_file
        from ray_tpu_torch.observability import events as _events

        exit_type = _events.classify_worker_exit(
            code, oom_killed=worker_id in self._oom_killed,
            intended=worker_id in self._intended_exit,
            preempted=worker_id in self._preempted)
        self._intended_exit.discard(worker_id)
        # Marks for workers retired outside the reaper's view (popped
        # from self.workers before the kill) are never consumed; bound
        # the set so long-lived churny raylets don't grow it forever.
        if len(self._intended_exit) > 4096:
            self._intended_exit.clear()
        k = GlobalConfig.worker_exit_tail_lines
        info = {
            "exit_type": exit_type,
            "exit_code": code,
            "oom_killed": exit_type == "OOM_KILLED",
            "preempted": exit_type == "PREEMPT_RESCHEDULE",
            "pid": handle.proc.pid,
            "node_id": self.node_id.hex(),
            "last_lines": tail_file(handle.out_path, k)
            if handle.out_path else [],
            "last_err_lines": tail_file(handle.err_path, k)
            if handle.err_path else [],
        }
        self._exit_info[worker_id] = info
        while len(self._exit_info) > 1024:
            self._exit_info.pop(next(iter(self._exit_info)))
        return info

    def _observe_worker_death(self, worker_id: bytes, handle,
                              code) -> Dict[str, Any]:
        """Classify a worker death and report the WORKER_EXIT event —
        exactly once, whichever path saw the corpse first. The reaper's
        200ms poll usually loses the race to the owner's return_worker
        RPC (the owner sees the connection drop within ms), so without
        the return-path hook most task-worker crashes would vanish from
        the event log unclassified."""
        if worker_id in self._exit_info:
            return self._exit_info[worker_id]
        from ray_tpu_torch.observability import events as _events

        info = self._classify_exit(worker_id, handle, code)
        exit_type = info["exit_type"]
        self._report_event(
            "WORKER_EXIT",
            f"worker {worker_id.hex()[:12]} (pid "
            f"{handle.proc.pid}) exited with code {code}: "
            f"{exit_type}",
            severity=_events.exit_severity(exit_type),
            worker_id=worker_id.hex(), pid=handle.proc.pid,
            exit_code=code, exit_type=exit_type,
            is_actor=handle.is_actor)
        return info

    async def _reaper_loop(self):
        """Detect dead worker processes; classify each exit from its
        waitpid status, capture log tails for forensics, report actor
        deaths (with the classification) and WORKER_EXIT events to GCS."""
        from ray_tpu_torch.observability import events as _events

        last_ttl_sweep = time.monotonic()
        while not self._dead:
            await asyncio.sleep(0.2)
            self._reap_dying()
            if time.monotonic() - last_ttl_sweep > 5.0:
                last_ttl_sweep = time.monotonic()
                self._sweep_idle_ttl()
            for worker_id, handle in list(self.workers.items()):
                code = handle.proc.poll()
                if code is None:
                    continue
                handle.registered.set()  # frees the spawn-throttle slot
                self.workers.pop(worker_id, None)
                self._release_worker_env(handle)
                if handle.addr == ("", 0):
                    # Died before registering: undo its _starting slot or the
                    # warm-pool floor is suppressed forever.
                    self._starting[handle.pool_key] = max(
                        0, self._starting[handle.pool_key] - 1)
                for oid in self._client_mapped.pop(worker_id, ()):
                    self.store.release_client(oid)
                try:
                    self._idle[handle.pool_key].remove(handle)
                except ValueError:
                    pass
                if handle.is_actor:
                    # Replace the dead actor worker eagerly so the next
                    # actor creation finds a warm process.
                    self._maybe_replenish(handle.job_id, handle.runtime_env)
                if handle.lease is not None:
                    self._release_lease(handle)
                self._release_orphaned_leases(worker_id)
                # Classification mutates loop-confined death bookkeeping
                # and must land before the actor-death report below; the
                # blocking leaf is a bounded tail of a local log file.
                info = self._observe_worker_death(worker_id, handle, code)  # graftlint: disable=async-blocking-transitive
                exit_type = info["exit_type"]
                if handle.is_actor and handle.actor_id is not None:
                    cause = (f"worker process exited with code {code} "
                             f"[{exit_type}]")
                    detail = _events.format_exit_detail(info)
                    try:
                        await self.gcs.acall(
                            "report_actor_death", actor_id=handle.actor_id,
                            cause=cause + detail, timeout=10)
                    except Exception:
                        pass

    async def _log_monitor_loop(self):
        """Tail worker logs and publish new lines to drivers (reference:
        `_private/log_monitor.py:103` — how task `print`s reach the
        driver terminal)."""
        from ray_tpu_torch._private.log_monitor import LogMonitor

        def info_of(wid_prefix: str):
            for worker_id, handle in self._worker_info_cache.items():
                if worker_id.hex().startswith(wid_prefix):
                    return handle
            return None

        def pid_of(wid_prefix: str):
            h = info_of(wid_prefix)
            return h.proc.pid if h else None

        monitor = LogMonitor(os.path.join(self.session_dir, "logs"),
                             pid_of=pid_of)
        while not self._dead:
            await asyncio.sleep(0.5)
            # Snapshot incl. recently-dead workers: their last lines must
            # still route to the right driver after the reaper pops them.
            for wid, h in self.workers.items():
                self._worker_info_cache[wid] = h
            while len(self._worker_info_cache) > 4096:
                self._worker_info_cache.pop(
                    next(iter(self._worker_info_cache)))
            for msg in monitor.scan():
                msg["ip"] = self.host
                msg["node_id"] = self.node_id.hex()
                h = info_of(msg["worker_id"])
                msg["job_id"] = h.job_id.hex() if h else None
                try:
                    await self.gcs.acall("publish", channel="logs",
                                         message=msg, timeout=10)
                except Exception:
                    pass

    async def _memory_monitor_loop(self):
        """OOM watchdog (reference: memory_monitor.h + worker_killing
        _policy.h): above the usage threshold, kill a leased task worker
        (newest lease first) so the task retries instead of the kernel
        OOM killer shooting the raylet or a GPU-holding actor."""
        from ray_tpu_torch._private import memory_monitor

        period = GlobalConfig.memory_monitor_refresh_ms / 1000
        if period <= 0:
            return
        threshold = GlobalConfig.memory_usage_threshold
        test_path = GlobalConfig.memory_monitor_test_usage_path
        while not self._dead:
            await asyncio.sleep(period)
            usage = await asyncio.get_running_loop().run_in_executor(
                None, memory_monitor.usage_fraction, test_path)
            if usage is None:
                continue
            if usage <= threshold:
                # Below the kill threshold but above the preempt
                # threshold: reschedule the largest leased task worker
                # NOW, while there is still headroom, instead of waiting
                # to shoot it with OOM_KILLED semantics.
                preempt_thr = GlobalConfig.memory_preempt_threshold
                # _preempt_for_memory calls record_decision(emit=False):
                # the sync-RPC branch the linter sees through the chain
                # is dead here — the decision record is forwarded via
                # acall below it.
                if preempt_thr and preempt_thr < usage and \
                        self._preempt_for_memory(usage, preempt_thr):  # graftlint: disable=async-blocking-transitive
                    await asyncio.sleep(max(period, 1.0))
                continue
            victim = await self._pick_oom_victim()
            if victim is None:
                continue
            self._oom_kills += 1
            self._oom_killed.add(victim.worker_id)
            if len(self._oom_killed) > 1024:
                self._oom_killed.pop()
            sys.stderr.write(
                f"[raylet {self.node_id.hex()[:8]}] memory usage "
                f"{usage:.2f} > {threshold:.2f}: OOM-killing worker "
                f"pid={victim.proc.pid} (actor={victim.is_actor})\n")
            try:
                self._retire_proc(victim.proc)
            except Exception:
                pass
            # Let the reaper pick up the death before re-sampling, so one
            # spike doesn't massacre the whole pool.
            await asyncio.sleep(max(period, 1.0))

    def _pick_preempt_victim(self):
        """Largest-RSS leased TASK worker. Preemption exists to avoid
        OOM kills, and tasks reschedule for free via the owner's crash
        retry; actors lose state, so they are never preempted — the
        hard kill path still considers them as a last resort."""
        leased = [h for h in self.workers.values()
                  if h.lease is not None and not h.is_actor]
        if not leased:
            return None
        rss: Dict[bytes, float] = {}
        try:
            import psutil

            for h in leased:
                try:
                    rss[h.worker_id] = float(
                        psutil.Process(h.proc.pid).memory_info().rss)
                except Exception:
                    pass
        except Exception:
            pass
        if rss:
            return max(leased, key=lambda h: rss.get(h.worker_id, -1.0))
        return leased[-1]  # no RSS signal: newest lease loses least work

    def _preempt_for_memory(self, usage: float, threshold: float) -> bool:
        """PREEMPT_RESCHEDULE: retire the victim so its lease returns
        through the normal death path (reaper -> _release_lease) and the
        owner's retry loop reruns the task elsewhere. Returns True when
        a victim was actually preempted. Rate-limited by
        memory_preempt_cooldown_s; if usage keeps climbing past the kill
        threshold anyway, the next monitor tick falls back to the
        OOM-kill branch."""
        now = time.monotonic()
        if now - self._last_preempt_ts < \
                GlobalConfig.memory_preempt_cooldown_s:
            return False
        victim = self._pick_preempt_victim()
        if victim is None:
            return False
        self._last_preempt_ts = now
        self._preempts += 1
        self._preempted.add(victim.worker_id)
        if len(self._preempted) > 1024:
            self._preempted.pop()
        sys.stderr.write(
            f"[raylet {self.node_id.hex()[:8]}] memory usage "
            f"{usage:.2f} > preempt threshold {threshold:.2f}: "
            f"rescheduling worker pid={victim.proc.pid}\n")
        try:
            from ray_tpu_torch.observability.control import record_decision

            # No global worker in a raylet: record_decision increments
            # the local counter (shipped with the next reporter-loop
            # metrics push) and we forward the decision record ourselves.
            payload = record_decision(
                "memory_preempt", "preempt_reschedule",
                "memory usage above preempt threshold",
                {"usage": round(usage, 3), "threshold": threshold,
                 "pid": victim.proc.pid,
                 "worker_id": victim.worker_id.hex()[:12]},
                node_id=self.node_id.hex(), emit=False)

            async def _send():
                try:
                    await self.gcs.acall("report_ctrl_decision",
                                         timeout=10, **payload)
                except Exception:
                    pass

            spawn_task(_send())
        except Exception:
            pass
        self._report_event(
            "PREEMPT_RESCHEDULE",
            f"memory usage {usage:.2f} above preempt threshold "
            f"{threshold:.2f}: rescheduling worker "
            f"{victim.worker_id.hex()[:12]} (pid {victim.proc.pid})",
            usage=round(usage, 3), threshold=threshold,
            pid=victim.proc.pid, worker_id=victim.worker_id.hex())
        try:
            self._retire_proc(victim.proc)
        except Exception:
            pass
        return True

    async def _reporter_loop(self):
        """Per-node resource reporter (reference: `dashboard/modules/
        reporter/reporter_agent.py:277`): node cpu/mem/disk, per-worker
        RSS, and GPU allocation, pushed as gauges through the
        existing metrics pipeline so they surface on the Prometheus
        endpoint and the dashboard."""
        try:
            import psutil
        except Exception:
            return
        node = self.node_id.hex()[:12]
        psutil.cpu_percent(interval=None)  # prime the sampler
        try:
            from ray_tpu_torch.observability.object_store import (
                register_store_sampler,
            )
            from ray_tpu_torch.util import metrics as _metrics

            register_store_sampler(self.store.stats, node)
        except Exception:
            _metrics = None

        def g(name, desc, tag_keys, data):
            return {"name": name, "type": "gauge", "description": desc,
                    "tag_keys": tuple(tag_keys), "default_tags": {},
                    "data": data}

        while not self._dead:
            await asyncio.sleep(GlobalConfig.metrics_report_interval_s)
            try:
                vm = psutil.virtual_memory()
                try:
                    disk = psutil.disk_usage(self.session_dir or "/")
                    disk_data = {f"{node},used": float(disk.used),
                                 f"{node},total": float(disk.total)}
                except Exception:
                    disk_data = {}
                rss = {}
                for h in list(self.workers.values()):
                    try:
                        rss[f"{node},{h.proc.pid}"] = float(
                            psutil.Process(h.proc.pid)
                            .memory_info().rss)
                    except Exception:
                        pass
                records = [
                    g("node_cpu_percent", "Node CPU utilization.",
                      ("node",), {node: psutil.cpu_percent(interval=None)}),
                    g("node_mem_used_bytes", "Node memory in use.",
                      ("node",), {node: float(vm.used)}),
                    g("node_mem_total_bytes", "Node memory capacity.",
                      ("node",), {node: float(vm.total)}),
                    g("node_disk_bytes",
                      "Session-dir filesystem usage by kind (used/total).",
                      ("node", "kind"), disk_data),
                    g("node_workers", "Live worker processes.",
                      ("node",), {node: float(len(self.workers))}),
                    g("node_gpus_free", "Unassigned GPUs.",
                      ("node",), {node: float(len(self._free_gpus))}),
                    # NOT tag key "pid": the gauge renderer appends its
                    # own pid=<source> label to every gauge and duplicate
                    # label names break the whole Prometheus scrape.
                    g("worker_rss_bytes", "Per-worker resident memory.",
                      ("node", "worker_pid"), rss),
                ]
                if _metrics is not None:
                    # The raylet has no global worker, so the shared
                    # metrics flusher never runs here — ship the
                    # registry (the object-store gauges/counters fed by
                    # the store sampler) with the reporter push instead.
                    records.extend(_metrics.snapshot_records())
                await self.gcs.acall("push_metrics",
                                     source=f"reporter:{node}",
                                     records=records, timeout=10)
            except Exception:
                pass
            # Spill watermark -> SPILL_PRESSURE cluster event: one event
            # per batch of new spills, not one per poll.
            try:
                stats = self.store.stats()
                spills = int(stats.get("num_spills", 0))
                if spills > self._spills_reported:
                    self._report_event(
                        "SPILL_PRESSURE",
                        f"object store spilled "
                        f"{spills - self._spills_reported} object(s) "
                        f"({int(stats.get('spilled_bytes', 0))} bytes "
                        f"spilled since start)",
                        num_spills=spills,
                        spilled_bytes=int(stats.get("spilled_bytes", 0)))
                    self._spills_reported = spills
            except Exception:
                pass

    async def _h_profile_worker(self, worker_id=None, duration_s=5.0,
                                kind="profile", hz=None):
        """On-demand worker profiling (reference: `profile_manager.py`):
        forwards to the worker's sampling profiler / stack dumper
        (``kind`` = "profile" | "stacks" | "tpu_profile", the last the
        worker's torch.profiler bracket). With no worker_id, covers every
        live worker on this node."""
        from ray_tpu_torch._private.rpc import RpcClient

        targets = ([self.workers[worker_id]] if worker_id in self.workers
                   else list(self.workers.values()) if worker_id is None
                   else [])

        async def one(h):
            try:
                client = self._worker_probe_clients.get(h.worker_id)
                if client is None:
                    client = RpcClient(*h.addr)
                    self._worker_probe_clients[h.worker_id] = client
                if kind in ("stacks", "dump_stacks"):
                    reply = await client.acall("dump_stacks", timeout=10)
                elif kind == "tpu_profile":
                    reply = await asyncio.wait_for(
                        client.acall("tpu_profile", duration_s=duration_s,
                                     timeout=duration_s + 60),
                        duration_s + 60)
                else:
                    reply = await asyncio.wait_for(
                        client.acall("profile", duration_s=duration_s,
                                     hz=hz, timeout=duration_s + 30),
                        duration_s + 30)
                return h.worker_id.hex(), reply
            except Exception as e:  # noqa: BLE001
                return h.worker_id.hex(), {"error": repr(e)}

        # Concurrent: whole-node profiling takes ~duration_s, not
        # duration_s * n_workers (the dashboard RPC has a fixed budget).
        pairs = await asyncio.gather(
            *(one(h) for h in targets if h.addr != ("", 0)))
        return dict(pairs)

    async def _h_dump_stacks(self, worker_id=None):
        """One-shot cluster-stack fan-out (the `ray stack` node hop):
        every live worker's all-thread Python stacks, keyed by worker id
        hex. util.state.stack() calls this on one or every raylet."""
        return await self._h_profile_worker(worker_id=worker_id,
                                            kind="stacks")

    async def _pick_oom_victim(self):
        """Worker-killing policy (reference `worker_killing_policy.h:34`):
        among leased workers, prefer one actually executing (killing an
        idle pool worker frees no task memory), prefer retriable tasks
        over actors (tasks retry for free; actors lose state), newest
        lease first (loses the least progress). Busy state comes from a
        short `busy_info` probe; an unresponsive worker counts as busy —
        a thrashing process can't answer and is the likeliest hog."""
        from ray_tpu_torch._private import memory_monitor
        from ray_tpu_torch._private.rpc import RpcClient

        leased = [h for h in self.workers.values() if h.lease is not None]
        if not leased:
            return None

        async def probe(h):
            # Bound the WHOLE probe (connect included — acall's timeout
            # starts after connect, and connect retries up to 10s): the
            # monitor must pick a victim before the kernel OOM killer does.
            try:
                client = self._worker_probe_clients.get(h.worker_id)
                if client is None:
                    client = RpcClient(*h.addr)
                    self._worker_probe_clients[h.worker_id] = client
                info = await asyncio.wait_for(
                    client.acall("busy_info", timeout=1.0), 1.0)
                return h.worker_id if info.get("executing") else None
            except Exception:
                # Unresponsive = likeliest hog (a thrashing process can't
                # answer): count as busy.
                return h.worker_id
        hits = await asyncio.gather(*(probe(h) for h in leased))
        busy = {wid for wid in hits if wid is not None}
        # Per-worker RSS so the kill is attributed to the worker actually
        # holding the memory, not whichever leased newest.
        rss: Dict[bytes, float] = {}
        try:
            import psutil

            for h in leased:
                try:
                    rss[h.worker_id] = float(
                        psutil.Process(h.proc.pid).memory_info().rss)
                except Exception:
                    pass
        except Exception:
            pass
        return memory_monitor.pick_victim(leased, busy, rss)

    # ---------------------------------------------------------- lease protocol
    def _strategy_allows_local(self, strategy) -> bool:
        """May a queued request be granted on THIS node once resources free
        up?  Hard affinity/labels elsewhere must never fall back to local."""
        if strategy.kind == "NODE_AFFINITY":
            return strategy.node_id == self.node_id or strategy.soft
        if strategy.kind == "NODE_LABEL":
            from ray_tpu_torch._private.scheduling_policy import _label_filter

            return self.node_id in _label_filter(self.view,
                                                 strategy.hard_labels)
        return True

    async def _h_request_worker_lease(self, demand, job_id, strategy_kind="DEFAULT",
                                      strategy_node=None, soft=False,
                                      hard_labels=None, soft_labels=None,
                                      lease_timeout=25.0, runtime_env=None,
                                      owner_id=None):
        """Returns {granted, worker_addr, worker_id, gpu_ids} |
        {spillback_to: addr} | {infeasible: True} | {timeout: True}."""
        from ray_tpu_torch._private.task_spec import SchedulingStrategySpec

        timeout = lease_timeout
        demand_rs = ResourceSet(demand)
        strategy = SchedulingStrategySpec(kind=strategy_kind,
                                          node_id=strategy_node, soft=soft,
                                          hard_labels=hard_labels or {},
                                          soft_labels=soft_labels or {})
        # A shape recorded as infeasible is not once a node could take it:
        # drop the record at once, or the autoscaler would launch for it
        # again until the record expires.
        if self._unfulfilled:
            key = tuple(sorted(demand_rs.to_dict().items()))
            if key in self._unfulfilled and is_feasible_anywhere(self.view,
                                                                 demand_rs):
                del self._unfulfilled[key]
        # Fast path: local node can serve now (and the strategy permits it).
        if (strategy_kind in ("DEFAULT", "PLACEMENT_GROUP")
                and self.local.available.is_superset_of(demand_rs)):
            return await self._grant_local(demand_rs, job_id, timeout,
                                           strategy, runtime_env, owner_id)

        target = pick_node(self.view, demand_rs, strategy, self.node_id)
        if target == self.node_id:
            return await self._grant_local(demand_rs, job_id, timeout,
                                           strategy, runtime_env, owner_id)
        if target is not None:
            return {"spillback_to": self._node_addrs.get(target),
                    "spillback_node": target}
        # No node can serve *now*. Queue locally only if this node is both
        # feasible and allowed by the strategy; otherwise let the owner retry
        # (the right node's raylet will queue it when targeted directly).
        if (self.local.is_feasible(demand_rs)
                and self._strategy_allows_local(strategy)):
            fut = asyncio.get_running_loop().create_future()
            self._lease_queue.append((demand_rs, job_id, strategy, fut,
                                      runtime_env, owner_id))
            self._lease_queue_event.set()
            try:
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                return {"timeout": True}
        if strategy.kind == "NODE_AFFINITY" and not strategy.soft:
            node = self.view.get(strategy.node_id)
            if node is None:
                # Target node unknown here — may be dead or just not yet in
                # this raylet's replicated view; let the owner retry until
                # its lease deadline rather than failing eagerly.
                return {"retry": True}
            if strategy.node_id != self.node_id:
                return {"spillback_to": self._node_addrs.get(strategy.node_id),
                        "spillback_node": strategy.node_id}
        if not is_feasible_anywhere(self.view, demand_rs):
            key = tuple(sorted(demand_rs.to_dict().items()))
            self._unfulfilled[key] = time.monotonic()
            return {"infeasible": True}
        return {"retry": True}

    async def _grant_local(self, demand: ResourceSet, job_id: bytes,
                           timeout: float, strategy=None, runtime_env=None,
                           owner_id=None):
        if runtime_env:
            failure = self._env_failures.get(
                self._pool_key(job_id, runtime_env))
            if failure is not None and time.monotonic() - failure[1] < 60:
                return {"env_setup_error": failure[0]}
        if not self.local.try_allocate(demand):
            fut = asyncio.get_running_loop().create_future()
            self._lease_queue.append((demand, job_id, strategy, fut,
                                      runtime_env, owner_id))
            self._lease_queue_event.set()
            try:
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                return {"timeout": True}
        gpu_ids = self._take_gpus(demand)
        handle = await self._pop_worker(job_id, runtime_env,
                                        gpu_ids=gpu_ids)
        if handle is None:
            self.local.release(demand)
            self._release_gpus(demand, gpu_ids)
            return {"timeout": True}
        handle.lease = {"demand": demand, "gpu_ids": gpu_ids,
                        "owner_id": owner_id}
        handle.lease_ts = time.monotonic()
        handle.lease_epoch += 1
        return {"granted": True, "worker_addr": handle.addr,
                "worker_id": handle.worker_id, "gpu_ids": gpu_ids,
                "lease_token": handle.lease_epoch}

    @staticmethod
    def _pg_gpu_demand(demand: ResourceSet):
        """(quantity, pg_hex) for placement-group-formatted GPU names
        (``GPU_group_{i}_{pg}`` / ``GPU_group_{pg}``), or (0, None)."""
        for name in demand.names():
            if name.startswith(f"{GPU}_group_"):
                return demand.get(name), name.rsplit("_", 1)[-1]
        return 0.0, None

    def _take_gpus(self, demand: ResourceSet) -> List[int]:
        pg_qty, pg_hex = self._pg_gpu_demand(demand)
        if pg_hex is not None:
            # GPUs for PG-formatted leases come from the bundle's own
            # reserved pool — indexed and wildcard names share one pool, so
            # a bundle's GPUs can never be double-assigned, and the node's
            # free list is untouched.
            pool = self._bundle_gpu_pool(pg_hex)
            n = max(1, int(pg_qty)) if pg_qty > 0 else 0
            take, remainder = pool[:n], pool[n:]
            self._set_bundle_gpu_pool(pg_hex, remainder)
            return take
        qty = demand.get(GPU)
        n = int(qty)
        if n <= 0:
            if qty <= 0:
                return []
            # Fractional share: dedicate one GPU to all fractional leases.
            if self._frac_gpu is None:
                if not self._free_gpus:
                    return []
                self._frac_gpu = self._free_gpus.pop(0)
            self._frac_users += 1
            return [self._frac_gpu]
        if len(self._free_gpus) < n:
            # Logical accounting granted more GPUs than physically free —
            # never hand out a short allocation silently.
            raise RuntimeError(
                f"GPU accounting out of sync: need {n}, free "
                f"{self._free_gpus}")
        take, self._free_gpus = (self._free_gpus[:n],
                                      self._free_gpus[n:])
        return take

    def _release_gpus(self, demand: ResourceSet, chips: List[int]) -> None:
        pg_qty, pg_hex = self._pg_gpu_demand(demand)
        if pg_hex is not None:
            self._set_bundle_gpu_pool(
                pg_hex, sorted(self._bundle_gpu_pool(pg_hex) + list(chips)))
            return
        qty = demand.get(GPU)
        if 0 < qty < 1:
            if not chips:
                # The acquire returned [] (no GPU was free); this lease
                # never became a fractional user — don't unbalance the count.
                return
            self._frac_users -= 1
            if self._frac_users <= 0 and self._frac_gpu is not None:
                self._free_gpus.append(self._frac_gpu)
                self._free_gpus.sort()
                self._frac_gpu = None
                self._frac_users = 0
            return
        for c in chips:
            if c not in self._free_gpus and c != self._frac_gpu:
                self._free_gpus.append(c)
        self._free_gpus.sort()

    def _bundle_gpu_pool(self, pg_hex: str) -> List[int]:
        out = []
        for (pg_id, _idx), bundle in self._bundles.items():
            if pg_id.hex() == pg_hex:
                out.extend(bundle.get("gpu_ids", []))
        return sorted(out)

    def _set_bundle_gpu_pool(self, pg_hex: str, chips: List[int]) -> None:
        """Redistribute the pool across the pg's bundles (pool is logically
        per-PG on this node; storage is per-bundle for return_bundle)."""
        chips = list(chips)
        entries = [(key, b) for key, b in self._bundles.items()
                   if key[0].hex() == pg_hex]
        for i, (key, bundle) in enumerate(entries):
            if i == len(entries) - 1:
                bundle["gpu_ids"] = chips
                chips = []
            else:
                cap = int(bundle["resources"].get(GPU))
                bundle["gpu_ids"] = chips[:cap]
                chips = chips[cap:]

    def _release_lease(self, handle: _WorkerHandle):
        lease = handle.lease
        handle.lease = None
        if lease is None:
            return
        self.local.release(lease["demand"])
        self._release_gpus(lease["demand"], lease["gpu_ids"])
        for key in [k for k, b in self._bundles.items()
                    if b.get("returning")]:
            if not self._pg_leased(key[0].hex()):
                self._return_bundle(key)
        self._lease_queue_event.set()

    def _release_orphaned_leases(self, owner_id: bytes) -> None:
        """Reclaim task-worker leases whose *owner* worker died on this
        node.  Leases are normally returned by the owner's idle sweeper,
        but a force-killed owner (e.g. ``ray_tpu_torch.kill`` of an actor that
        was mid-stream driving remote tasks) never gets to return them —
        observed as a streaming_split coordinator kill landing inside the
        owner's 0.5s lease-idle window and permanently leaking the leased
        CPUs, wedging every later lease request on the saturated node.
        Dedicated actor workers are excluded: their lifetime belongs to
        the GCS actor manager, not to a task lease."""
        if not owner_id:
            return
        for h in list(self.workers.values()):
            if (h.is_actor or h.lease is None
                    or h.lease.get("owner_id") != owner_id):
                continue
            sys.stderr.write(
                f"[raylet] reclaiming lease of worker "
                f"{h.worker_id.hex()[:12]}: owner "
                f"{owner_id.hex()[:12]} died\n")
            self._report_event(
                "LEASE_RECLAIMED",
                f"reclaimed lease of worker {h.worker_id.hex()[:12]}: "
                f"owner {owner_id.hex()[:12]} died",
                worker_id=h.worker_id.hex(), owner_id=owner_id.hex())
            self._release_lease(h)
            # The worker may still be executing a push from the dead
            # owner; its results have nowhere to go, so retire the
            # process rather than re-offering it mid-task.
            self.workers.pop(h.worker_id, None)
            self._release_worker_env(h)
            self._intended_exit.add(h.worker_id)
            self._retire_proc(h.proc)

    async def _lease_dispatch_loop(self):
        """Re-schedule queued lease requests whenever resources free up or the
        cluster view changes — including spilling a queued task to another
        node that became (or became known to be) available, mirroring the
        reference's ScheduleAndDispatchTasks re-runs."""
        from ray_tpu_torch._private.task_spec import SchedulingStrategySpec

        default = SchedulingStrategySpec()
        while not self._dead:
            try:
                await asyncio.wait_for(self._lease_queue_event.wait(), 0.1)
            except asyncio.TimeoutError:
                pass
            self._lease_queue_event.clear()
            pending = len(self._lease_queue)
            for _ in range(pending):
                (demand, job_id, strategy, fut,
                 runtime_env, owner_id) = self._lease_queue.popleft()
                if fut.done():
                    continue
                if self.local.available.is_superset_of(demand):
                    reply = await self._grant_local(demand, job_id, 60.0,
                                                    strategy, runtime_env,
                                                    owner_id)
                    if not fut.done():
                        fut.set_result(reply)
                    continue
                target = pick_node(self.view, demand, strategy or default,
                                   self.node_id)
                if (target is not None and target != self.node_id
                        and target in self._node_addrs):
                    if not fut.done():
                        fut.set_result(
                            {"spillback_to": self._node_addrs[target],
                             "spillback_node": target})
                    continue
                self._lease_queue.append((demand, job_id, strategy, fut,
                                          runtime_env, owner_id))
            await asyncio.sleep(0.005)

    async def _h_return_worker(self, worker_id, kill=False,
                               lease_token=None):
        handle = self.workers.get(worker_id)
        if handle is None:
            return False
        # Reject stale returns: a return frame can be processed long
        # after it was sent (busy raylet), by which time the worker may
        # hold a NEWER lease — possibly as a dedicated actor. Applying
        # the stale return would strip that lease, re-offer the worker
        # to the idle pool, and let a later task-lease failure SIGKILL
        # a live actor.
        if lease_token is not None and lease_token != handle.lease_epoch:
            return False
        if handle.is_actor:
            # Task-lease returns never apply to dedicated actor workers
            # (defense in depth for token-less callers).
            sys.stderr.write(
                f"[raylet] ignoring return_worker for actor worker "
                f"{worker_id.hex()[:12]}\n")
            return False
        self._release_lease(handle)
        code = handle.proc.poll()
        if code is None and (worker_id in self._oom_killed
                             or worker_id in self._preempted):
            # The memory monitor shot this worker and its SIGKILL is
            # still in flight: the owner's ConnectionLost discard beat
            # waitpid. Taking the kill branch below would mark the death
            # INTENDED_EXIT and pop the handle before anyone classified
            # it — the OOM would vanish from the event log. Leave the
            # corpse-to-be in self.workers; the reaper's poll classifies
            # and reports it within a tick.
            return True
        if kill or code is not None:
            self.workers.pop(worker_id, None)
            self._release_worker_env(handle)
            if code is None:
                self._intended_exit.add(worker_id)
                self._retire_proc(handle.proc)
            else:
                # The worker is already a corpse: the owner noticed the
                # crash and returned the lease before the reaper's poll.
                # Classify + report here or the death never hits the
                # event log. Loop-confined bookkeeping; the blocking leaf
                # is a bounded tail of a local log file.
                self._observe_worker_death(worker_id, handle, code)  # graftlint: disable=async-blocking-transitive
        else:
            self._offer_worker(handle)
        return True

    async def _h_lease_worker_for_actor(self, spec, demand):
        demand_rs = ResourceSet(demand)
        renv = getattr(spec, "runtime_env", None)
        if renv:
            failure = self._env_failures.get(
                self._pool_key(spec.job_id.binary(), renv))
            if failure is not None and time.monotonic() - failure[1] < 60:
                return {"ok": False, "env_setup_error": failure[0],
                        "reason": f"runtime_env setup failed: {failure[0]}"}
        if not self.local.try_allocate(demand_rs):
            return {"ok": False, "reason": "resources busy"}
        gpu_ids = self._take_gpus(demand_rs)
        handle = await self._pop_worker(spec.job_id.binary(),
                                        getattr(spec, "runtime_env", None),
                                        dedicated=True, gpu_ids=gpu_ids)
        if handle is None:
            self.local.release(demand_rs)
            self._release_gpus(demand_rs, gpu_ids)
            return {"ok": False, "reason": "no worker"}
        handle.lease = {"demand": demand_rs, "gpu_ids": gpu_ids}
        handle.lease_ts = time.monotonic()
        handle.lease_epoch += 1
        handle.is_actor = True
        handle.actor_id = spec.actor_id.binary()
        return {"ok": True, "worker_addr": handle.addr,
                "worker_id": handle.worker_id, "gpu_ids": gpu_ids}

    async def _h_worker_exiting(self, worker_id):
        self._intended_exit.add(worker_id)
        handle = self.workers.pop(worker_id, None)
        if handle is not None:
            self._release_lease(handle)
            self._release_worker_env(handle)
            try:
                self._idle[handle.pool_key].remove(handle)
            except ValueError:
                pass
            self._release_orphaned_leases(worker_id)
        return True

    async def _h_kill_worker(self, worker_id, force=True):
        handle = self.workers.get(worker_id)
        if handle is None:
            return False
        # A kill the framework itself issued must not read as
        # SYSTEM_ERROR when the reaper classifies the SIGKILL.
        self._intended_exit.add(worker_id)
        if force:
            self._retire_proc(handle.proc)
        else:
            try:
                handle.proc.terminate()  # graceful; the reaper collects it
            except Exception:
                pass
            self._dying.append(handle.proc)
        return True

    # ------------------------------------------------------------ object store
    async def _h_create_object(self, object_id, size):
        path, offset = await self.store.create_async(object_id, size)
        return {"path": path, "offset": offset}

    async def _h_seal_object(self, object_id, pin=False):
        self.store.seal(object_id)
        if pin:
            self.store.pin(object_id)
        return True

    async def _h_put_object(self, object_id, payload, pin=False):
        """One-RPC put for small/medium objects: create+write+seal(+pin).

        The payload rides the RPC frame (one extra copy) in exchange for a
        single round trip — the client-side 3-RPC create/seal/pin dance
        dominated small-put latency (reference bar: ray_perf.py put suites).
        """
        await self.store.put_bytes_async(object_id, payload)
        if pin:
            self.store.pin(object_id)
        return True

    def _track_client_ref(self, object_id, client_id) -> None:
        self.store.addref_client(object_id)
        if client_id:
            self._client_mapped[client_id].add(object_id)

    async def _h_get_object(self, object_id, wait_timeout=None, locations=None,
                            client_id=None):
        timeout = wait_timeout
        """Wait locally; if absent and locations are known, pull from a
        remote raylet in chunks (reference: PullManager + ObjectManager)."""
        found = await self.store.get(object_id, timeout=0.0)
        if found is not None:
            self._track_client_ref(object_id, client_id)
            return {"path": found[0], "size": found[1],
                    "offset": found[2]}
        if locations:
            for node_id in locations:
                if node_id == self.node_id:
                    continue
                addr = self._node_addrs.get(node_id)
                if addr is None:
                    continue
                try:
                    await self._pull_from(object_id, addr)
                    found = await self.store.get(object_id, timeout=1.0)
                    if found is not None:
                        self._track_client_ref(object_id, client_id)
                        return {"path": found[0], "size": found[1],
                                "offset": found[2]}
                except Exception:
                    continue
            # The owner's directory said where the copies are and every
            # pull failed (nodes dead / object gone). Fail fast: the owner
            # can reconstruct via lineage; blocking the full client timeout
            # here just delays recovery.
            found = await self.store.get(object_id,
                                         timeout=min(timeout or 2.0, 2.0))
        else:
            found = await self.store.get(object_id, timeout=timeout)
        if found is None:
            return {"not_found": True}
        self._track_client_ref(object_id, client_id)
        return {"path": found[0], "size": found[1], "offset": found[2]}

    async def _pull_from(self, object_id, addr: Tuple[str, int]):
        client = self._remote_client(addr)
        info = await client.acall("object_info", object_id=object_id,
                                  timeout=30)
        if info is None:
            raise KeyError("remote object gone")
        size = info["size"]
        chunk = GlobalConfig.object_manager_chunk_size
        await self.store.create_async(object_id, size)
        for offset in range(0, size, chunk):
            data = await client.acall(
                "read_chunk", object_id=object_id, offset=offset,
                length=min(chunk, size - offset), timeout=60)
            self.store.write_into(object_id, offset, data)
        self.store.seal(object_id)

    def _remote_client(self, addr) -> RpcClient:
        addr = tuple(addr)
        if addr not in self._remote_raylets:
            self._remote_raylets[addr] = RpcClient(*addr)
        return self._remote_raylets[addr]

    async def _h_release_object(self, object_id, client_id=None):
        self.store.release_client(object_id)
        if client_id:
            self._client_mapped[client_id].discard(object_id)
        return True

    async def _h_release_objects(self, object_ids, client_id=None):
        for oid in object_ids:
            self.store.release_client(oid)
            if client_id:
                self._client_mapped[client_id].discard(oid)
        return True

    async def _h_contains_object(self, object_id):
        return self.store.contains(object_id)

    async def _h_object_info(self, object_id):
        if not self.store.contains(object_id):
            return None
        return {"size": self.store.size_of(object_id)}

    async def _h_read_chunk(self, object_id, offset, length):
        return self.store.read_bytes(object_id, offset, length)

    async def _h_delete_objects(self, object_ids):
        self.store.delete(object_ids)
        return True

    async def _h_pin_object(self, object_id):
        self.store.pin(object_id)
        return True

    async def _h_unpin_object(self, object_id):
        self.store.unpin(object_id)
        return True

    async def _h_store_stats(self):
        return self.store.stats()

    async def _h_memory_stats(self, top_n=50):
        """One-shot memory introspection snapshot for `memory_summary()`
        and `GET /api/memory`: the store's aggregate stats plus the
        largest objects it is tracking."""
        return {"store": self.store.stats(),
                "objects": self.store.object_table(int(top_n) or 50)}

    # -------------------------------------------------------------- PG bundles
    async def _h_prepare_bundle(self, pg_id, bundle_index, resources):
        """Phase 1: reserve the bundle's resources (reversible)."""
        key = (pg_id, bundle_index)
        if key in self._bundles:
            return True
        demand = ResourceSet(resources)
        if not self.local.try_allocate(demand):
            return False
        # Reserve physical GPUs for the bundle now; PG-formatted leases
        # later draw from this pool instead of the node's free list.
        gpu_ids = self._take_gpus(demand)
        self._bundles[key] = {"resources": demand, "committed": False,
                              "gpu_ids": gpu_ids, "took": list(gpu_ids)}
        return True

    async def _h_commit_bundle(self, pg_id, bundle_index):
        """Phase 2: mint the bundle-formatted resources on this node
        (reference formatted-resource scheme: `CPU_group_{i}_{pg}` etc.)."""
        from ray_tpu_torch._private.resources import pg_bundle_grant

        key = (pg_id, bundle_index)
        bundle = self._bundles.get(key)
        if bundle is None or bundle["committed"]:
            return bundle is not None
        add = pg_bundle_grant(bundle["resources"], pg_id.hex(), bundle_index)
        self.local.total = self.local.total.add(add)
        self.local.available = self.local.available.add(add)
        bundle["committed"] = True
        bundle["formatted"] = add
        self._lease_queue_event.set()
        return True

    def _pg_leased(self, pg_hex: str) -> bool:
        """Whether a live lease on this node draws on the group's bundles."""
        return any(
            h.lease is not None
            and any("_group_" in n and n.endswith(f"_{pg_hex}")
                    for n in h.lease["demand"].names())
            for h in self.workers.values())

    async def _h_return_bundle(self, pg_id, bundle_index):
        key = (pg_id, bundle_index)
        bundle = self._bundles.get(key)
        if bundle is None:
            return True
        if self._pg_leased(pg_id.hex()):
            # The group was removed under a live lease (its job's driver
            # is gone and the actor is still exiting): the bundle stays,
            # with what the lease holds of it, until the group's last
            # lease here ends (_release_lease returns it then).
            bundle["returning"] = True
            return True
        self._return_bundle(key)
        return True

    def _return_bundle(self, key) -> None:
        pg_hex = key[0].hex()
        pool = self._bundle_gpu_pool(pg_hex)
        bundle = self._bundles.pop(key)
        # The chips its prepare took go back as that take was made (a
        # fractional bundle's share of the shared chip included); the
        # group's other bundles keep the rest of the pool.
        took = bundle.get("took", [])
        for c in took:
            if c in pool:
                pool.remove(c)
        self._set_bundle_gpu_pool(pg_hex, pool)
        self._release_gpus(bundle["resources"], took)
        if bundle["committed"]:
            add = bundle["formatted"]
            self.local.total = self.local.total.subtract(add)
            self.local.available = self.local.available.subtract(add)
            # Clamp negatives (a task may still hold formatted resources).
            if self.local.available.has_negative():
                fixed = {k: max(0, v) for k, v in
                         self.local.available._fixed.items()}
                self.local.available = ResourceSet(_fixed=fixed)
        self.local.release(bundle["resources"])

    # ------------------------------------------------------------------- misc
    async def _h_node_stats(self):
        return {
            "node_id": self.node_id,
            "resources_total": self.local.total.to_dict(),
            "resources_available": self.local.available.to_dict(),
            "num_workers": len(self.workers),
            "store": self.store.stats(),
            "event_stats": self.server.stats.snapshot(),
            "oom_kills": self._oom_kills,
            "memory_preempts": self._preempts,
        }

    async def _h_get_worker_exit_info(self, worker_id):
        """Why did this worker die? Lets the owner raise OutOfMemoryError
        instead of a generic WorkerCrashedError, and enrich the death
        error with the exit classification + the worker's last log lines
        (reference: exit-type plumbing in worker failure RPCs)."""
        info = dict(self._exit_info.get(worker_id) or {})
        info["oom_killed"] = (info.get("oom_killed", False)
                              or worker_id in self._oom_killed)
        info["preempted"] = (info.get("preempted", False)
                             or worker_id in self._preempted)
        return info

    async def _h_get_log(self, worker_id=None, task_id=None, tail=100):
        """Per-task / per-worker log retrieval over the raylet (reference:
        `ListLogs`/`StreamLog` in the reference dashboard agent). Log
        files outlive their workers, so this serves dead workers too —
        exactly the ones a postmortem cares about. Returns {"lines":
        [...]} where stderr lines follow stdout lines per file."""
        from ray_tpu_torch._private import log_monitor

        tail = max(int(tail), 0)
        log_dir = os.path.join(self.session_dir, "logs") \
            if self.session_dir else ""

        def _scan() -> List[str]:
            # Pure file reads over an arbitrary number of worker logs:
            # runs in the executor so a fat log can't stall the raylet.
            lines: List[str] = []
            if worker_id is not None:
                wid_hex = worker_id.hex() if isinstance(worker_id, bytes) \
                    else str(worker_id)
                prefix = wid_hex[:12]
                for suffix in (".out", ".err"):
                    path = os.path.join(log_dir, f"worker-{prefix}{suffix}")
                    got = log_monitor.read_task_lines(
                        path, task_id_hex=None, max_lines=tail)
                    if got and suffix == ".err":
                        lines.extend(f"[stderr] {ln}" for ln in got)
                    else:
                        lines.extend(got)
            elif task_id is not None:
                tid_hex = task_id.hex() if isinstance(task_id, bytes) \
                    else str(task_id)
                try:
                    names = sorted(os.listdir(log_dir))
                except OSError:
                    names = []
                for name in names:
                    if not (name.startswith("worker-")
                            and name.endswith((".out", ".err"))):
                        continue
                    got = log_monitor.read_task_lines(
                        os.path.join(log_dir, name), task_id_hex=tid_hex,
                        max_lines=tail)
                    if got and name.endswith(".err"):
                        lines.extend(f"[stderr] {ln}" for ln in got)
                    else:
                        lines.extend(got)
            return lines

        lines = await asyncio.get_running_loop().run_in_executor(None, _scan)
        if tail:
            lines = lines[-tail:]
        return {"lines": lines}

    async def _h_get_tasks_info(self):
        out = []
        for w in self.workers.values():
            if w.lease is not None:
                out.append({"worker_id": w.worker_id, "is_actor": w.is_actor,
                            "actor_id": w.actor_id})
        return out

    async def _h_shutdown_node(self):
        asyncio.get_running_loop().call_later(0.05, self.shutdown)
        return True

    def shutdown(self):
        self._dead = True
        for handle in self.workers.values():
            try:
                self._retire_proc(handle.proc)
            except Exception:
                pass
        self.store.cleanup()
        os._exit(0)


def main():
    # SIGUSR1 dumps all thread stacks to the daemon log (see gcs_server).
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
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--resources", required=True)
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--object-store-capacity", type=int, default=0)
    parser.add_argument("--fate-share-pid", type=int, default=0)
    args = parser.parse_args()

    capacity = args.object_store_capacity or GlobalConfig.object_store_memory
    import signal

    raylet = Raylet(
        node_id=bytes.fromhex(args.node_id),
        host=args.host,
        gcs_addr=(args.gcs_host, args.gcs_port),
        resources=json.loads(args.resources),
        labels=json.loads(args.labels),
        session_dir=args.session_dir,
        object_store_capacity=capacity,
        port=args.port,
    )
    # Graceful termination must clean the node's /dev/shm store files.
    signal.signal(signal.SIGTERM, lambda *_: raylet.shutdown())
    from ray_tpu_torch._private.fate_share import watch_parent

    # Clean the object store before exiting on spawner death too.
    watch_parent(args.fate_share_pid, on_death=raylet.shutdown)
    port = raylet.start()
    print(f"RAYLET_PORT={port}", flush=True)
    import threading
    threading.Event().wait()


if __name__ == "__main__":
    main()
