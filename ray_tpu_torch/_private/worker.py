"""Core worker — the in-process runtime of every driver and worker.

Role-equivalent to the reference's `src/ray/core_worker/` + the Python side of
`_private/worker.py`: object put/get/wait over a two-tier store (in-process
memory store for small/inlined objects — `memory_store.h:43` — and the node's
shared-memory store), task submission over the raylet lease protocol with
spillback (`direct_task_transport.h:75`), direct ordered actor transport with
per-caller sequence numbers (`direct_actor_task_submitter.h`,
`actor_scheduling_queue.h`), owner-side retries (`task_manager.cc:896`), and
the task execution loop.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import sys
import threading
import time
from collections import defaultdict, deque
from functools import partial
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import (
    ActorID, JobID, ObjectID, TaskID, WorkerID, _IndexCounter,
)
from ray_tpu_torch._private.object_ref import ObjectRef, reduce_object_ref
from ray_tpu_torch._private.object_store import MappedObject, WritableObject
from ray_tpu_torch._private.reference_count import ReferenceCounter
from ray_tpu_torch._private.resources import GPU, ResourceSet
from ray_tpu_torch._private.rpc import (ConnectionLost, RpcClient, RpcServer,
                                  get_io_loop, spawn_task)
from ray_tpu_torch._private.serialization import (
    SerializationContext, SerializedObject, deserialize_error, serialize_error,
)
from ray_tpu_torch._private.task_spec import (
    ArgSpec, FunctionDescriptor, SchedulingStrategySpec, TaskSpec, TaskType,
)

MODE_DRIVER = "driver"
MODE_WORKER = "worker"

_global_worker: Optional["Worker"] = None
_global_lock = threading.Lock()


def global_worker() -> "Worker":
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first.")
    return _global_worker


def global_worker_or_none() -> Optional["Worker"]:
    return _global_worker


def set_global_worker(w: Optional["Worker"]) -> None:
    global _global_worker
    _global_worker = w


def _current_wire_trace() -> Optional[Dict[str, Any]]:
    """The caller's active TraceContext as a compact wire dict for the
    TaskSpec (None when no trace is active) — the submit side of
    request-scoped trace propagation (util/tracing.py)."""
    from ray_tpu_torch.util.tracing import current_wire_context

    return current_wire_context()


class _PendingObject:
    """Memory-store entry: resolves to inline bytes, a plasma copy, or error."""

    __slots__ = ("event", "inline", "error", "in_plasma", "waiters")

    def __init__(self):
        self.event = threading.Event()
        self.inline: Optional[bytes] = None
        self.error: Optional[bytes] = None
        self.in_plasma = False
        self.waiters: List[asyncio.Future] = []


class _GeneratorState:
    """Owner-side progress of one streaming/dynamic generator task."""

    __slots__ = ("produced", "total", "error", "cond")

    def __init__(self):
        self.produced = 0               # item refs completed so far
        self.total: Optional[int] = None  # set when the generator finishes
        self.error: Optional[bytes] = None
        self.cond = threading.Condition()


class _ActorState:
    """Executing-side actor state (instance + ordered scheduling queues)."""

    def __init__(self, instance, spec: TaskSpec):
        self.instance = instance
        self.spec = spec
        self.max_concurrency = max(1, spec.max_concurrency)
        self.is_async = spec.is_async_actor
        self.executors: Dict[str, ThreadPoolExecutor] = {}
        if not self.is_async:
            self.executors[""] = ThreadPoolExecutor(
                max_workers=self.max_concurrency,
                thread_name_prefix="actor-exec")
        self.semaphore = asyncio.Semaphore(self.max_concurrency)
        # per-caller ordering
        self.expected_seq: Dict[bytes, int] = defaultdict(int)
        self.pending: Dict[bytes, Dict[int, asyncio.Future]] = defaultdict(dict)

    def executor_for(self, group: str) -> ThreadPoolExecutor:
        if group not in self.executors:
            self.executors[group] = ThreadPoolExecutor(
                max_workers=max(1, self.max_concurrency),
                thread_name_prefix=f"actor-cg-{group}")
        return self.executors[group]


class ActorHandleTracker:
    """Owner-side actor handle GC (reference: actors die when all handles go
    out of scope, AFTER their outstanding tasks drain). Serialized handles
    conservatively pin the actor.

    All state mutation runs on the io event loop — finalizers (`__del__`)
    must not take locks, since cyclic GC can fire them on a thread already
    inside this tracker.
    """

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self._counts: Dict[bytes, int] = defaultdict(int)
        self._inflight: Dict[bytes, int] = defaultdict(int)
        self._shared: set = set()
        self._created_by_us: set = set()
        self._kill_when_drained: set = set()

    def _post(self, fn) -> None:
        if not self._worker._dead:
            try:
                self._worker.io.loop.call_soon_threadsafe(fn)
            except Exception:
                pass

    def mark_created(self, actor_id: bytes) -> None:
        self._post(lambda: self._created_by_us.add(actor_id))

    def mark_shared(self, actor_id: bytes) -> None:
        self._post(lambda: self._shared.add(actor_id))

    def add_ref(self, actor_id: bytes) -> None:
        self._post(lambda: self._counts.__setitem__(
            actor_id, self._counts[actor_id] + 1))

    def remove_ref(self, actor_id: bytes) -> None:
        """GC-context entry (ActorHandle.__del__): append-only.

        `_post`/call_soon_threadsafe takes the event loop's internal
        mutex — if cyclic GC fires this __del__ on the io-loop thread
        while it is INSIDE call_soon_threadsafe, re-taking that mutex
        self-deadlocks (same class as the ObjectRef.__del__ hang). The
        worker's release drainer applies the decrefs."""
        self._worker._pending_actor_releases.append(actor_id)

    def apply_deferred_release(self, actor_id: bytes) -> None:
        """Drain-point counterpart of remove_ref (non-GC context)."""
        def _dec():
            self._counts[actor_id] -= 1
            self._maybe_gc(actor_id)

        self._post(_dec)

    # Called from the io loop only (submit/complete paths).
    def task_submitted(self, actor_id: bytes) -> None:
        self._inflight[actor_id] += 1

    def task_completed(self, actor_id: bytes) -> None:
        self._inflight[actor_id] -= 1
        if actor_id in self._kill_when_drained:
            self._maybe_gc(actor_id)

    def _maybe_gc(self, actor_id: bytes) -> None:
        if (self._counts[actor_id] > 0
                or actor_id not in self._created_by_us
                or actor_id in self._shared):
            return
        if self._inflight[actor_id] > 0:
            # Reference semantics: let submitted work finish first.
            self._kill_when_drained.add(actor_id)
            return
        self._created_by_us.discard(actor_id)
        self._kill_when_drained.discard(actor_id)
        if not self._worker._dead:
            try:
                self._worker.io.submit(self._worker.gcs.acall(
                    "gc_actor", actor_id=actor_id, timeout=10))
            except Exception:
                pass


class _ActorAddrUnavailable(Exception):
    """The actor has no live address (dead / never became ready)."""


class _LeaseState:
    """Per-scheduling-shape lease bookkeeping on the owner."""

    __slots__ = ("idle", "waiters", "inflight", "event",
                 "dispatcher_started", "pushing", "remote_pending")

    def __init__(self):
        self.idle: deque = deque()      # parked reusable leases
        self.waiters: deque = deque()   # (spec, future) awaiting dispatch
        self.inflight = 0               # raylet lease requests in flight
        self.event = asyncio.Event()    # wakes the dispatcher
        self.dispatcher_started = False
        self.pushing = 0                # batch pushes currently in flight
        # Lease requests currently parked at a *remote* raylet (after a
        # spillback). Each one is an expected grant on an other-node worker;
        # the dispatcher must not starve those nodes by reusing a local
        # finished lease for the waiter the remote grant is coming for
        # (reference contract: the leased-worker cache never starves an
        # idle node — `direct_task_transport.cc:600`).
        self.remote_pending = 0


class _WorkerCrashed:
    """Dispatch outcome: the pushed-to worker died mid-task."""

    __slots__ = ("worker_id", "lessor")

    def __init__(self, worker_id, lessor):
        self.worker_id = worker_id
        self.lessor = lessor


_CANCELLED_SENTINEL = object()


class _ActorSendQueue:
    __slots__ = ("queue", "event", "task")

    def __init__(self):
        self.queue: deque = deque()
        self.event = asyncio.Event()
        self.task = None


class _TaskContext(threading.local):
    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.task_name: str = ""
        self.gpu_ids: List[int] = []


class Worker:
    def __init__(self, mode: str, gcs_addr: Tuple[str, int],
                 raylet_addr: Tuple[str, int], node_id: bytes,
                 job_id: JobID, worker_id: Optional[WorkerID] = None,
                 session_dir: str = ""):
        self.mode = mode
        self.node_id = node_id
        self.job_id = job_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.session_dir = session_dir
        self.io = get_io_loop()

        self.gcs = RpcClient(*gcs_addr)
        self.gcs_addr = gcs_addr
        self.raylet = RpcClient(*raylet_addr)
        self.raylet_addr = raylet_addr

        # Core worker RPC service (worker<->worker plane). Bind the node's
        # routable interface (exported by the raylet) so two physical hosts
        # can exchange owner RPCs and object pulls; loopback only when
        # standalone.
        bind_host = os.environ.get("RAY_TPU_NODE_IP") or raylet_addr[0]
        self.server = RpcServer(bind_host, 0)
        for name in ["push_task", "push_tasks", "create_actor",
                     "push_actor_task",
                     "get_object_status", "kill_self", "cancel_task", "ping",
                     "busy_info", "add_borrower", "release_borrower",
                     "consume_pending_share",
                     "stack_dump", "dump_stacks", "profile", "tpu_profile",
                     "delete_object_notification", "report_generator_item",
                     "recover_object", "wait_object_status",
                     "early_task_result"]:
            self.server.register(name, getattr(self, f"_h_{name}"))
        self.port = self.server.start()
        self.addr = (bind_host, self.port)

        # serialization
        self.serialization = SerializationContext()
        self.serialization.register_reducer(ObjectRef, reduce_object_ref)
        from ray_tpu_torch.actor import ActorHandle, reduce_actor_handle

        self.serialization.register_reducer(ActorHandle, reduce_actor_handle)

        # object state
        self.reference_counter = ReferenceCounter(
            on_free=self._free_object,
            on_borrow_release=self._send_borrow_release,
            on_contained_free=self._release_contained)
        # oids this process has announced itself as borrowing (dedupes the
        # per-deserialize registration RPC; cleared on release).
        self._borrow_registered: Set[bytes] = set()
        self.serialization._on_deserialize.append(self._register_borrows)
        # _dead must exist before the sweeper's first loop check — the io
        # loop thread is already running and can win the race against the
        # rest of __init__.
        self._dead = False
        self.io.submit(self._borrow_sweeper())
        self.actor_handles = ActorHandleTracker(self)
        self._objects: Dict[bytes, _PendingObject] = {}
        self._objects_lock = threading.Lock()
        # Deferred ref releases from ObjectRef.__del__. A __del__ can run
        # inside ANY allocation on ANY thread — including one already
        # holding _objects_lock (e.g. _entry building a _PendingObject) —
        # so it must never call into the refcounter/free path directly:
        # remove_local_ref -> _free_object re-takes _objects_lock and
        # self-deadlocks while holding the refcount lock, wedging every
        # other thread (observed as the serve-suite hang). __del__ only
        # appends here (GIL-atomic); drains run at public entry points
        # and from the release-drainer io task. Reference analogue:
        # core_worker defers Python refcount ops onto the io_service.
        import collections as _collections

        self._pending_releases: "_collections.deque[bytes]" = \
            _collections.deque()
        # Same contract for MappedObject view releases (raylet client-ref
        # drops) and ActorHandle.__del__ decrefs: GC-time callbacks
        # append; the drainer applies them.
        self._pending_map_releases: "_collections.deque[bytes]" = \
            _collections.deque()
        self._pending_actor_releases: "_collections.deque[bytes]" = \
            _collections.deque()
        self.io.submit(self._release_drainer())
        # Weak cache of client mappings: entries vanish when the last
        # deserialized value sharing the buffer dies, firing the
        # mapping's release callback so the raylet drops its client ref
        # (plasma buffer-release semantics — a strong cache kept every
        # read object reader-pinned forever and wedged small arenas).
        import weakref

        self._mapped: "weakref.WeakValueDictionary[bytes, MappedObject]" = \
            weakref.WeakValueDictionary()

        # counters
        self._put_counter = _IndexCounter()
        self._task_counter = _IndexCounter()
        self._put_inflight = threading.BoundedSemaphore(
            GlobalConfig.async_put_max_inflight)
        self._pending_deletes: Dict[bytes, List[bytes]] = {}
        self._pending_deletes_lock = threading.Lock()
        self._delete_flusher_started = False

        # submission state
        self._worker_clients: Dict[Tuple[str, int], RpcClient] = {}
        self._raylet_clients: Dict[Tuple[str, int], RpcClient] = {self.raylet_addr: self.raylet}
        self._actor_addr_cache: Dict[bytes, Tuple[str, int]] = {}
        self._actor_seq: Dict[bytes, int] = defaultdict(int)
        self._actor_incarnation: Dict[bytes, int] = {}
        self._actor_submit_locks: Dict[bytes, asyncio.Lock] = {}
        self._actor_batchers: Dict[bytes, "_ActorSendQueue"] = {}
        self._exported_functions: set = set()
        self._prepared_env_cache: Dict[str, Dict[str, Any]] = {}
        self._exported_payloads: Dict[str, bytes] = {}
        self._cancelled_tasks: set = set()
        # task_id -> executing worker addr, while a push RPC is in flight
        # (real cancel needs the executing worker, not a broadcast).
        self._inflight_push: Dict[bytes, Tuple[str, int]] = {}
        # Dispatch futures for multi-task push batches, keyed by task id —
        # the early_task_result side channel resolves them before the
        # aggregate batch reply lands (anti-deadlock; see _h_push_tasks).
        self._inflight_futs: Dict[bytes, Any] = {}
        # Leased-worker reuse (reference: direct task submitter lease
        # caching in `lease_policy.h` / `normal_task_submitter`): a lease
        # whose task finished cleanly is handed to the next same-shaped
        # waiting task (or parked briefly) without another raylet round
        # trip. A sweeper returns leases idle too long.
        self._lease_pool: Dict[str, _LeaseState] = {}
        self._lease_pool_sweeper_started = False
        # fn hash -> EMA of worker-measured execution seconds, for the
        # batch-or-not dispatch decision.
        self._fn_dur_ema: Dict[str, float] = {}
        # Streaming/dynamic generator tasks: task_id -> production state.
        self._generators: Dict[bytes, _GeneratorState] = {}
        # Lineage (object reconstruction): task_id -> spec of the creating
        # task, dropped when all its return objects are freed
        # (reference: `task_manager.cc` lineage + `object_recovery_manager.h:90`).
        self._lineage: Dict[bytes, TaskSpec] = {}
        self._lineage_live: Dict[bytes, int] = {}
        self._recovering: Dict[bytes, threading.Event] = {}
        # Task lifecycle events, flushed to the GCS task manager in batches
        # (reference: `task_event_buffer.h:206` -> `gcs_task_manager.h:85`).
        self._task_events: List[Dict[str, Any]] = []
        self._task_events_lock = threading.Lock()
        self._task_events_flush_pending = False

        # execution state
        self._fn_cache: Dict[str, Any] = {}
        self._task_executor = ThreadPoolExecutor(
            max_workers=max(4, (os.cpu_count() or 4)),
            thread_name_prefix="task-exec")
        self._actor: Optional[_ActorState] = None
        self._ctx = _TaskContext()
        self._running_task_threads: Dict[bytes, threading.Thread] = {}
        # task_id -> thread ident, for async cancel of a RUNNING task,
        # plus the inverse so cancel can verify the thread still runs THAT
        # task before injecting (thread reuse race).
        self._executing_tids: Dict[bytes, int] = {}
        self._thread_task: Dict[int, bytes] = {}

        self._dead = False

        self.gcs.call("register_worker", worker_id=self.worker_id.binary(),
                      info={"worker_id": self.worker_id.binary(),
                            "node_id": node_id, "mode": mode,
                            "addr": self.addr, "pid": os.getpid(),
                            "job_id": job_id.binary()})

        async def _task_event_flusher():
            while not self._dead:
                await asyncio.sleep(2.0)
                self.flush_task_events()

        self.io.submit(_task_event_flusher())

    # ======================================================================
    # Object plane
    # ======================================================================
    def _entry(self, oid: bytes, create: bool = True) -> Optional[_PendingObject]:
        with self._objects_lock:
            entry = self._objects.get(oid)
            if entry is None and create:
                entry = self._objects[oid] = _PendingObject()
            return entry

    def _complete_object(self, oid: bytes, *, inline: Optional[bytes] = None,
                         error: Optional[bytes] = None,
                         in_plasma: bool = False) -> None:
        entry = self._entry(oid)
        entry.inline = inline
        entry.error = error
        entry.in_plasma = in_plasma
        entry.event.set()
        if entry.waiters:
            waiters, entry.waiters = entry.waiters, []

            def _wake():
                for f in waiters:
                    if not f.done():
                        f.set_result(None)

            self.io.loop.call_soon_threadsafe(_wake)

    async def _await_entry(self, oid: bytes, timeout: Optional[float]) -> bool:
        entry = self._entry(oid)
        if entry.event.is_set():
            return True
        fut = asyncio.get_running_loop().create_future()
        entry.waiters.append(fut)
        if entry.event.is_set() and not fut.done():
            fut.set_result(None)
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def put(self, value: Any) -> ObjectRef:
        self.drain_releases()
        task_id = self._ctx.task_id or TaskID.for_normal_task(self.job_id)
        oid_obj = ObjectID.for_put(task_id, self._put_counter.next())
        oid = oid_obj.binary()
        self.reference_counter.add_owned(oid)
        self._store_value(oid, value)
        return ObjectRef(oid, self.addr, self.worker_id.binary())

    def _store_value(self, oid: bytes, value: Any) -> None:
        sobj = self.serialization.serialize(value)
        # Refs nested in the stored value stay alive while this object
        # does (object-keyed borrow; reference: nested refs in
        # reference_count.cc).
        self._adopt_contained(oid, self.serialization.last_contained_refs)
        if sobj.total_size <= GlobalConfig.max_direct_call_object_size:
            self._complete_object(oid, inline=sobj.to_bytes())
        elif sobj.total_size <= GlobalConfig.rpc_put_max_bytes:
            # Pipelined single-RPC put: the staging copy decouples the
            # object from later caller-side mutation, then the whole
            # create+write+seal happens in one raylet round trip that the
            # caller never waits on (ray.get blocks on the entry instead).
            self._async_plasma_put(oid, sobj.to_bytes())
        else:
            self._plasma_put(oid, sobj)
            self.reference_counter.add_location(oid, self.node_id)
            self._complete_object(oid, in_plasma=True)

    def _async_plasma_put(self, oid: bytes, payload: bytes) -> None:
        self._put_inflight.acquire()

        async def _chain():
            try:
                await self.raylet.acall(
                    "put_object", object_id=oid, payload=payload, pin=True,
                    timeout=60)
                if self.reference_counter.is_freed(oid):
                    # Every ref was dropped while the put was in flight:
                    # nobody will ever decref again, so delete the pinned
                    # copy now or it leaks in the arena forever.
                    await self.raylet.acall("delete_objects",
                                            object_ids=[oid], timeout=10)
                    return
                self.reference_counter.add_location(oid, self.node_id)
                self._complete_object(oid, in_plasma=True)
            except Exception as e:  # noqa: BLE001 — surfaces at get()
                self._complete_object(oid, error=serialize_error(e))
            finally:
                self._put_inflight.release()

        try:
            self.io.submit(_chain())
        except Exception:
            self._put_inflight.release()
            raise

    def _plasma_put(self, oid: bytes, sobj: SerializedObject) -> None:
        reply = self.raylet.call("create_object", object_id=oid,
                                 size=sobj.total_size)
        wobj = WritableObject(reply["path"], sobj.total_size,
                              reply.get("offset", 0))
        try:
            sobj.write_into(wobj.view)
        finally:
            wobj.close()
        self.raylet.call("seal_object", object_id=oid, pin=True)

    def _release_mapping(self, oid: bytes) -> None:
        """MappedObject release callback: the last value view died.

        Usually fires from GC (the WeakValueDictionary entry dying), so
        it must stay lock-free like ObjectRef.__del__ — io.submit takes
        the asyncio loop's internal mutex and can self-deadlock if the
        collection happens inside call_soon_threadsafe on the loop
        thread. Defer; the drainer sends the raylet release."""
        if self._dead:
            return
        self._pending_map_releases.append(oid)

    def _plasma_get(self, oid: bytes, timeout: Optional[float],
                    locations: Sequence[bytes]) -> Any:
        mobj = self._mapped.get(oid)
        if mobj is None:
            reply = self.raylet.call("get_object", object_id=oid,
                                     wait_timeout=timeout,
                                     locations=list(locations),
                                     client_id=self.worker_id.binary())
            if reply.get("not_found"):
                raise exc.ObjectLostError(
                    f"object {oid.hex()} not found in the cluster")
            mobj = MappedObject(reply["path"], reply["size"],
                                reply.get("offset", 0),
                                on_release=partial(
                                    self._release_mapping, oid))
            self._mapped[oid] = mobj
        return self.serialization.deserialize(mobj.view, keepalive=mobj)

    def get_objects(self, refs: Sequence[ObjectRef],
                    timeout: Optional[float]) -> List[Any]:
        self.drain_releases()
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            out.append(self._get_one(ref, remaining))
        return out

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        oid = ref.binary()
        entry = self._entry(oid, create=False)
        owned = entry is not None or ref.owner_addr == self.addr
        if owned:
            if self.reference_counter.is_freed(oid):
                raise exc.ObjectLostError(
                    f"object {oid.hex()} was already freed by its owner")
            entry = self._entry(oid)
            if not self._wait_entry(entry, timeout, oid):
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {oid.hex()}")
            return self._materialize(oid, entry, timeout)
        return self._borrowed_get(ref, timeout)

    def _wait_entry(self, entry, timeout: Optional[float],
                    oid: bytes) -> bool:
        """Event-wait in slices so a get() can notice that the runtime it
        is waiting on has died (worker shutdown, io loop gone) instead of
        sleeping out its entire — possibly 600 s — budget on an object
        that can no longer arrive. Emits a progress diagnostic every
        couple of minutes so a wedged suite run leaves a trail."""
        deadline = None if timeout is None else time.monotonic() + timeout
        waited = 0.0
        while True:
            # Already-resolved objects succeed even at timeout=0 — a
            # zero budget means "don't block", not "don't look".
            if entry.event.is_set():
                return True
            slice_s = 30.0
            if deadline is not None:
                slice_s = min(slice_s, deadline - time.monotonic())
                if slice_s <= 0:
                    return False
            if entry.event.wait(slice_s):
                return True
            waited += slice_s
            if self._dead:
                raise exc.RaySystemError(
                    f"worker shut down while waiting for {oid.hex()}")
            if not self.io._thread.is_alive():
                raise exc.RaySystemError(
                    f"io loop died while waiting for {oid.hex()}")
            if waited >= 120 and int(waited) % 120 < 30:
                print(f"[worker] still waiting for {oid.hex()} after "
                      f"{waited:.0f}s (task dispatch pending)",
                      file=sys.stderr, flush=True)

    def _materialize(self, oid: bytes, entry: _PendingObject,
                     timeout: Optional[float], _recovered: bool = False) -> Any:
        if entry.error is not None:
            self._raise_task_error(entry.error)
        if entry.inline is not None:
            return self.serialization.deserialize(memoryview(entry.inline))
        if entry.in_plasma:
            try:
                return self._plasma_get(
                    oid, timeout, self.reference_counter.locations(oid))
            except exc.ObjectLostError:
                if _recovered or not self._try_recover_object(oid, timeout):
                    raise
                entry = self._entry(oid)
                if not entry.event.wait(timeout if timeout is not None
                                        else 300):
                    raise
                return self._materialize(oid, entry, timeout,
                                         _recovered=True)
        raise exc.ObjectLostError(f"object {oid.hex()} has no value")

    def _raise_task_error(self, payload: bytes):
        cause, tb = deserialize_error(payload)
        if isinstance(cause, exc.RayTpuError) and not isinstance(
                cause, exc.RayTaskError):
            raise cause
        raise exc.RayTaskError(cause, tb).as_instanceof_cause()

    def _borrowed_get(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        oid = ref.binary()
        deadline = None if timeout is None else time.monotonic() + timeout
        owner = self._client_for(tuple(ref.owner_addr))
        recovery_attempts = 0
        first = True
        while True:
            try:
                if first:
                    # Fast path: object usually already resolved.
                    status = owner.call("get_object_status", object_id=oid,
                                        timeout=30)
                    first = False
                else:
                    window = 10.0
                    if deadline is not None:
                        window = max(0.05, min(
                            window, deadline - time.monotonic()))
                    status = owner.call("wait_object_status", object_id=oid,
                                        wait_timeout=window,
                                        timeout=window + 30)
            except (ConnectionLost, OSError):
                raise exc.OwnerDiedError(
                    f"owner of {oid.hex()} at {ref.owner_addr} is unreachable; "
                    "the object is lost") from None
            kind = status.get("status")
            if kind == "inline":
                return self.serialization.deserialize(
                    memoryview(status["data"]))
            if kind == "plasma":
                try:
                    return self._plasma_get(
                        oid,
                        None if deadline is None else max(
                            0.1, deadline - time.monotonic()),
                        status["locations"])
                except exc.ObjectLostError:
                    # All copies gone — ask the owner to reconstruct via
                    # lineage, then re-resolve. Bounded by the caller's
                    # remaining get() budget.
                    recovery_attempts += 1
                    if recovery_attempts > 2:
                        raise
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise exc.GetTimeoutError(
                            f"get() timed out during recovery of "
                            f"{oid.hex()}") from None
                    reply = owner.call(
                        "recover_object", object_id=oid,
                        timeout=(310 if remaining is None
                                 else min(remaining + 10, 310)))
                    if not reply.get("ok"):
                        raise
                    continue
            if kind == "error":
                self._raise_task_error(status["error"])
            if kind == "freed":
                raise exc.ObjectLostError(
                    f"object {oid.hex()} was freed by its owner")
            if deadline is not None and time.monotonic() > deadline:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for borrowed {oid.hex()}")

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        refs = list(refs)
        ready_ids: set = set()   # sticky: a ready object stays ready
        delay = 0.002
        while True:
            ready, not_ready = [], []
            for ref in refs:
                if ref.binary() in ready_ids or self._is_ready(ref):
                    ready_ids.add(ref.binary())
                    ready.append(ref)
                else:
                    not_ready.append(ref)
            if len(ready) >= num_returns or (
                    deadline is not None and time.monotonic() >= deadline):
                # Reference semantics: at most num_returns refs are reported
                # ready; the surplus stays in the not-ready list, in order.
                capped = ready[:num_returns]
                capped_ids = {id(r) for r in capped}
                rest = [r for r in refs if id(r) not in capped_ids]
                return capped, rest
            time.sleep(delay)
            delay = min(delay * 1.5, 0.05)

    def _is_ready(self, ref: ObjectRef) -> bool:
        entry = self._entry(ref.binary(), create=False)
        if entry is not None:
            return entry.event.is_set()
        if ref.owner_addr == self.addr:
            return False
        try:
            status = self._client_for(tuple(ref.owner_addr)).call(
                "get_object_status", object_id=ref.binary(), timeout=10)
            return status.get("status") != "pending"
        except Exception:
            return True  # owner dead => get() will raise; counts as "ready"

    def _free_object(self, oid: bytes, locations: set) -> None:
        """ReferenceCounter callback — remove the value everywhere."""
        with self._objects_lock:
            self._objects.pop(oid, None)

        tid = bytes(oid[:TaskID.SIZE])
        live = self._lineage_live.get(tid)
        if live is not None:
            live -= 1
            if live <= 0:
                self._drop_lineage(tid)
            else:
                self._lineage_live[tid] = live
        mobj = self._mapped.pop(oid, None)
        if mobj is not None:
            mobj.close()  # fires the release callback exactly once
        if self._dead:
            return
        if not locations and mobj is None:
            # Inline-only object: nothing lives in any node store — a
            # delete RPC per freed ref would dominate small-task GC.
            return
        # Batched store deletion: freed plasma objects accumulate and one
        # delete_objects RPC per node flushes them (500 puts freed at once
        # previously spawned 500 RPC chains).
        with self._pending_deletes_lock:
            for node in locations | {self.node_id}:
                self._pending_deletes.setdefault(node, []).append(oid)
            start = not self._delete_flusher_started
            self._delete_flusher_started = True
        if start:
            try:
                self.io.submit(self._delete_flusher())
            except Exception:
                pass

    # ---- borrower protocol (reference: reference_count.cc borrowed refs,
    # WaitForRefRemoved; here: explicit register/release RPCs + TTL'd
    # pending-share pins + owner-side borrower liveness sweep) ------------

    def _register_borrows(self, borrowed) -> None:
        """Deserialize hook: we just rehydrated refs owned elsewhere —
        announce the borrow to each owner before the value is usable."""
        if not borrowed or self._dead:
            return
        for oid, owner_addr in borrowed:
            if oid in self._borrow_registered:
                # Already a registered borrower: this extra copy's
                # serialize-out still appended a pending share owner-side
                # that nothing would ever consume (it would pin the object
                # for the full TTL — ADVICE r4 low). Retire it now; the
                # registered borrow itself keeps the object alive.
                self._consume_share_async(oid, owner_addr)
                continue
            # Optimistic dedupe entry (prevents duplicate RPCs from rapid
            # repeated deserializes); rolled back on failure so the next
            # deserialize retries the registration.
            self._borrow_registered.add(oid)
            try:
                if threading.current_thread() is getattr(
                        self.io, "_thread", None):
                    # On the io loop itself a sync RPC would deadlock;
                    # fire async — the serializer's pending-share pin (or
                    # the caller's task-dep pin) covers the gap.
                    self.io.submit(self._register_borrow_async(
                        oid, owner_addr))
                else:
                    self._client_for(owner_addr).call(
                        "add_borrower", object_id=oid,
                        key=self.worker_id.binary(),
                        addr=list(self.addr), timeout=30)
            except Exception:
                # Owner unreachable NOW: drop the dedupe entry so a later
                # deserialize retries; until then the ref may dangle and
                # get() surfaces ObjectLostError.
                self._borrow_registered.discard(oid)

    def _consume_share_async(self, oid: bytes, owner_addr) -> None:
        """Best-effort, fire-and-forget: tell the owner one in-flight
        pending share was delivered to an already-registered borrower.
        Never retried (shares are fungible; an over-consume could drop
        the pin covering a different in-flight copy), so a lost message
        just falls back to the TTL sweep."""
        if self._dead or owner_addr is None:
            return

        async def _go():
            try:
                await self._client_for(tuple(owner_addr)).acall(
                    "consume_pending_share", object_id=oid, timeout=30)
            except Exception:
                pass

        try:
            self.io.submit(_go())
        except Exception:
            pass

    async def _h_consume_pending_share(self, object_id):
        self.reference_counter.consume_pending_share(object_id)
        return True

    async def _register_borrow_async(self, oid: bytes, owner_addr) -> None:
        try:
            await self._client_for(owner_addr).acall(
                "add_borrower", object_id=oid,
                key=self.worker_id.binary(),
                addr=list(self.addr), timeout=30)
        except Exception:
            self._borrow_registered.discard(oid)

    def _send_borrow_release(self, oid: bytes, addr) -> None:
        """ReferenceCounter callback (borrower side): our last hold on a
        borrowed ref drained."""
        self._borrow_registered.discard(oid)
        if self._dead:
            return

        async def _go():
            try:
                await self._client_for(tuple(addr)).acall(
                    "release_borrower", object_id=oid,
                    key=self.worker_id.binary(), timeout=30)
            except Exception:
                pass

        try:
            self.io.submit(_go())
        except Exception:
            pass

    def _release_contained(self, outer: bytes, inners) -> None:
        """ReferenceCounter callback (owner side): a freed object's value
        embedded other refs — drop the object-keyed holds."""
        key = b"obj:" + outer
        for inner, iaddr in inners:
            if iaddr is None or tuple(iaddr) == self.addr:
                self.reference_counter.release_borrower(inner, key)
            elif not self._dead:
                async def _go(a=tuple(iaddr), i=inner):
                    try:
                        await self._client_for(a).acall(
                            "release_borrower", object_id=i, key=key,
                            timeout=30)
                    except Exception:
                        pass

                try:
                    self.io.submit(_go())
                except Exception:
                    pass

    def _adopt_contained(self, outer: bytes, inners) -> None:
        """We own `outer`, whose sealed value embeds `inners`: hold an
        object-keyed borrow on each until `outer` is freed."""
        if not inners:
            return
        key = b"obj:" + outer
        recorded = []
        for inner, iaddr in inners:
            iaddr = tuple(iaddr) if iaddr else None
            if iaddr is None or iaddr == self.addr:
                self.reference_counter.register_borrower(inner, key, None)
                recorded.append((inner, None))
            else:
                client = self._client_for(iaddr)
                try:
                    # Carry OUR address so the inner owner's liveness
                    # sweep can reap the object-keyed hold if this
                    # process dies before freeing `outer`.
                    self.io.submit(client.acall(
                        "add_borrower", object_id=inner, key=key,
                        addr=list(self.addr), timeout=30))
                except Exception:
                    pass
                recorded.append((inner, iaddr))
        self.reference_counter.set_contained(outer, recorded)

    async def _h_add_borrower(self, object_id, key, addr=None):
        return {"ok": self.reference_counter.register_borrower(
            object_id, key, tuple(addr) if addr else None)}

    async def _h_release_borrower(self, object_id, key):
        self.reference_counter.release_borrower(object_id, key)
        return True

    def defer_release(self, oid: bytes) -> None:
        """GC-safe local-ref release (ObjectRef.__del__ only): a single
        lock-free append; the actual decref runs at the next drain."""
        self._pending_releases.append(oid)

    def drain_releases(self) -> None:
        """Apply deferred __del__ releases. Called from public entry
        points (never while holding _objects_lock) and periodically."""
        q = self._pending_releases
        big = len(q) > 100_000
        if big:
            t0 = time.monotonic()
            n0 = len(q)
        while q:
            try:
                oid = q.popleft()
            except IndexError:
                break
            try:
                self.reference_counter.remove_local_ref(oid)
            except Exception:
                pass
        if big:
            print(f"[worker] drained {n0} deferred releases in "
                  f"{time.monotonic() - t0:.2f}s", file=sys.stderr,
                  flush=True)
        aq = self._pending_actor_releases
        while aq:
            try:
                actor_id = aq.popleft()
            except IndexError:
                break
            try:
                self.actor_handles.apply_deferred_release(actor_id)
            except Exception:
                pass
        mq = self._pending_map_releases
        while mq and not self._dead:
            try:
                oid = mq.popleft()
            except IndexError:
                break
            try:
                self.io.submit(self.raylet.acall(
                    "release_object", object_id=oid,
                    client_id=self.worker_id.binary(), timeout=5))
            except Exception:
                pass

    async def _release_drainer(self):
        while not self._dead:
            await asyncio.sleep(0.2)
            if self._pending_releases or self._pending_map_releases:
                self.drain_releases()

    async def _borrow_sweeper(self):
        """Owner-side hygiene: expire unclaimed pending-share pins and
        reap borrowers whose process died without releasing."""
        fails: Dict[Tuple[str, int], int] = {}
        while not self._dead:
            ttl = GlobalConfig.borrow_pending_ttl_s
            await asyncio.sleep(min(30.0, max(0.5, ttl / 4)))
            if self._dead:
                return
            try:
                self.reference_counter.expire_pending(ttl)
                for addr, entries in list(
                        self.reference_counter.borrower_addrs().items()):
                    if addr == self.addr:
                        continue
                    try:
                        await asyncio.wait_for(
                            self._client_for(addr).acall("ping", timeout=5),
                            5)
                        fails.pop(addr, None)
                    except Exception:
                        n = fails.get(addr, 0) + 1
                        fails[addr] = n
                        if n >= 3:
                            fails.pop(addr, None)
                            for oid, bkey in entries:
                                self.reference_counter.release_borrower(
                                    oid, bkey)
            except Exception:
                pass

    async def _delete_flusher(self):
        while not self._dead:
            await asyncio.sleep(0.05)
            with self._pending_deletes_lock:
                batch, self._pending_deletes = self._pending_deletes, {}
            for node, oids in batch.items():
                client = (self.raylet if node == self.node_id
                          else await self._araylet_for_node(node))
                if client is None:
                    continue
                try:
                    await client.acall("delete_objects", object_ids=oids,
                                       timeout=10)
                except Exception:
                    pass

    async def _araylet_for_node(self, node_id: bytes) -> Optional[RpcClient]:
        try:
            nodes = await self.gcs.acall("get_all_nodes", timeout=5)
        except Exception:
            return None
        for n in nodes:
            if n["node_id"] == node_id and n["state"] == "ALIVE":
                return self._raylet_client(tuple(n["addr"]))
        return None

    def _raylet_for_node(self, node_id: bytes) -> Optional[RpcClient]:
        # Resolve a raylet address through GCS (cached by addr).
        try:
            nodes = self.gcs.call("get_all_nodes", timeout=5)
        except Exception:
            return None
        for n in nodes:
            if n["node_id"] == node_id and n["state"] == "ALIVE":
                return self._raylet_client(tuple(n["addr"]))
        return None

    def _raylet_client(self, addr: Tuple[str, int]) -> RpcClient:
        if addr not in self._raylet_clients:
            self._raylet_clients[addr] = RpcClient(*addr)
        return self._raylet_clients[addr]

    def _client_for(self, addr: Tuple[str, int]) -> RpcClient:
        addr = tuple(addr)
        if addr not in self._worker_clients:
            self._worker_clients[addr] = RpcClient(*addr)
        return self._worker_clients[addr]

    # ======================================================================
    # Normal task submission (owner side)
    # ======================================================================
    def export_function(self, payload: bytes) -> str:
        fn_hash = hashlib.sha256(payload).hexdigest()[:32]
        if fn_hash not in self._exported_functions:
            self.gcs.call("kv_put", namespace="fn", key=fn_hash,
                          value=payload, overwrite=False)
            self._exported_functions.add(fn_hash)
            # Keep the payload: a bounced GCS may have snapshotted before
            # this export landed, in which case the owner re-exports on
            # the first function-not-found task failure.
            self._exported_payloads[fn_hash] = payload
        return fn_hash

    async def _maybe_reexport(self, fn_hash: str) -> bool:
        payload = self._exported_payloads.get(fn_hash)
        if payload is None:
            return False
        try:
            await self.gcs.acall("kv_put", namespace="fn", key=fn_hash,
                                 value=payload, overwrite=True, timeout=10)
            return True
        except Exception:
            return False

    def _serialize_args(self, args: Sequence[Any], kwargs: Dict[str, Any]
                        ) -> Tuple[List[ArgSpec], List[str]]:
        specs: List[ArgSpec] = []
        all_args = list(args) + list(kwargs.values())
        for value in all_args:
            if isinstance(value, ObjectRef):
                self.reference_counter.add_task_dependency(value.binary())
                specs.append(ArgSpec(
                    is_ref=True, object_id=value.binary(),
                    owner_addr=value.owner_addr))
                continue
            sobj = self.serialization.serialize(value)
            if sobj.total_size <= GlobalConfig.max_direct_call_object_size:
                specs.append(ArgSpec(is_ref=False, inline_data=sobj.to_bytes()))
            else:
                ref = self.put(value)
                self.reference_counter.add_task_dependency(ref.binary())
                specs.append(ArgSpec(is_ref=True, object_id=ref.binary(),
                                     owner_addr=ref.owner_addr))
        return specs, list(kwargs.keys())

    def _prepare_runtime_env(self, env):
        """Driver-side runtime_env normalization + code packaging
        (reference: upload_working_dir_if_needed): validates the spec,
        zips local working_dir / py_modules into content-addressed GCS
        packages, and caches the rewritten env so repeated submissions
        don't re-hash directories."""
        if not env:
            return None
        import json as _json

        key = _json.dumps(env, sort_keys=True, default=str)
        prepared = self._prepared_env_cache.get(key)
        if prepared is None:
            from ray_tpu_torch.runtime_env.manager import prepare_runtime_env

            prepared = prepare_runtime_env(env, self.gcs) or {}
            self._prepared_env_cache[key] = prepared
        return prepared or None

    def submit_task(self, fn_hash: str, fn_name: str, args, kwargs,
                    options: Dict[str, Any]) -> List[ObjectRef]:
        self.drain_releases()
        task_id = TaskID.for_normal_task(self.job_id)
        arg_specs, kw_keys = self._serialize_args(args, kwargs)
        num_returns = options.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if isinstance(num_returns, str):
            num_returns = {"dynamic": -1, "streaming": -2}[num_returns]
        resources = _resources_from_options(options)
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id,
            task_type=TaskType.NORMAL_TASK,
            function=FunctionDescriptor("", fn_name, fn_hash),
            args=arg_specs, kwargs_keys=kw_keys,
            num_returns=num_returns, resources=resources,
            owner_addr=self.addr, owner_worker_id=self.worker_id,
            name=options.get("name") or fn_name,
            scheduling=_strategy_from_options(options),
            max_retries=options.get("max_retries",
                                    GlobalConfig.task_max_retries_default),
            retry_exceptions=options.get("retry_exceptions", False),
            runtime_env=self._prepare_runtime_env(
                options.get("runtime_env")),
            parent_task_id=self._ctx.task_id,
            labels=options.get("_labels") or {},
            trace_ctx=_current_wire_trace(),
        )
        refs = []
        for rid in spec.return_ids():
            self.reference_counter.add_owned(rid.binary())
            self._entry(rid.binary())
            refs.append(ObjectRef(rid.binary(), self.addr,
                                  self.worker_id.binary()))
        if spec.max_retries != 0:
            tid = task_id.binary()
            self._lineage[tid] = spec
            self._lineage_live[tid] = len(refs)
        if num_returns < 0:
            # Register generator state before dispatch: a streaming item
            # push may arrive before the submit coroutine even runs.
            self._generators[task_id.binary()] = _GeneratorState()
        if GlobalConfig.sched_phase_instrumentation:
            # Phase breakdown anchor: the same wall clock goes into the
            # task-event ring and the spec stash, so the histogram and
            # the timeline segments agree to the microsecond.
            spec.phase_ts = {"PENDING": time.time()}
            self._record_task_event(spec, "PENDING",
                                    ts=spec.phase_ts["PENDING"])
        else:
            self._record_task_event(spec, "PENDING")
        self.io.submit(self._run_normal_task(spec))
        if streaming:
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            gen = ObjectRefGenerator(task_id.binary(), self.addr,
                                     self.worker_id.binary())
            gen._ref0 = refs[0]  # keeps the generator ref (and lineage) alive
            return [gen]
        return refs

    def _record_task_event(self, spec: TaskSpec, state: str,
                           **extra) -> None:
        event = {
            "task_id": spec.task_id.binary(), "name": spec.name,
            "job_id": spec.job_id.binary(), "state": state,
            "ts": time.time(), "owner_pid": os.getpid(),
            "parent_task_id": (spec.parent_task_id.binary()
                               if spec.parent_task_id else None),
            **extra,
        }
        with self._task_events_lock:
            self._task_events.append(event)
            flush = len(self._task_events) >= 100
        if flush:
            self.flush_task_events()

    def flush_task_events(self) -> None:
        with self._task_events_lock:
            batch, self._task_events = self._task_events, []
        if not batch or self._dead:
            return

        async def _push():
            try:
                await self.gcs.acall("push_task_events", events=batch,
                                     timeout=10)
            except Exception:
                pass

        try:
            self.io.submit(_push())
        except Exception:
            pass

    def flush_task_events_soon(self, delay: float = 0.5) -> None:
        """Debounced flush: schedule one flush ``delay`` seconds out,
        coalescing every request made while it is pending. Trace-tagged
        spans use this so traces assemble at the GCS on a sub-second
        cadence without a per-span RPC (the plain batch flush only
        fires at 100 buffered events or shutdown). Thread-safe —
        ``EventLoopThread.submit`` is."""
        if self._dead:
            return
        with self._task_events_lock:
            if self._task_events_flush_pending:
                return
            self._task_events_flush_pending = True

        async def _later():
            try:
                await asyncio.sleep(delay)
            finally:
                with self._task_events_lock:
                    self._task_events_flush_pending = False
            self.flush_task_events()

        try:
            self.io.submit(_later())
        except Exception:
            with self._task_events_lock:
                self._task_events_flush_pending = False

    def _record_reply_phases(self, spec: TaskSpec,
                             wphases: Dict[str, float],
                             worker_addr) -> None:
        """Owner-side landing of the executing worker's phase clocks
        (WORKER_STARTED / ARGS_READY / RUNNING, stamped worker-side and
        carried in the task reply): append them to the task-event ring
        with their original timestamps — the refined RUNNING supersedes
        the push-time one in the timeline — and fold the full
        PENDING->...->RUNNING chain into rtpu_sched_phase_seconds."""
        from ray_tpu_torch.observability import profiling as _profiling

        for state in ("WORKER_STARTED", "ARGS_READY", "RUNNING"):
            ts = wphases.get(state)
            if ts is None:
                continue
            extra = {"ts": ts}
            if state == "RUNNING":
                extra["worker_addr"] = list(worker_addr)
            self._record_task_event(spec, state, **extra)
        chain = dict(spec.phase_ts or {})
        chain.update(wphases)
        try:
            _profiling.observe_sched_phases(chain)
        except Exception:
            pass  # metrics must never fail a task

    async def _resolve_deps(self, spec: TaskSpec) -> Optional[bytes]:
        """Wait for owned arg refs to be available; returns error payload if a
        dependency failed (which poisons this task)."""
        for arg in spec.args:
            if not arg.is_ref:
                continue
            if tuple(arg.owner_addr) == self.addr:
                await self._await_entry(arg.object_id, None)
                entry = self._entry(arg.object_id)
                if entry.error is not None:
                    return entry.error
            else:
                owner = self._client_for(tuple(arg.owner_addr))
                while True:
                    try:
                        # Long-poll: the owner replies when the object
                        # resolves (or its window closes), instead of the
                        # submitter burning a 10ms poll loop per dep.
                        status = await owner.acall(
                            "wait_object_status", object_id=arg.object_id,
                            wait_timeout=10.0, timeout=40)
                    except (ConnectionLost, OSError):
                        return serialize_error(exc.OwnerDiedError(
                            f"owner of dependency {arg.object_id.hex()} died"))
                    if status.get("status") == "error":
                        return status["error"]
                    if status.get("status") != "pending":
                        break
        return None

    async def _run_normal_task(self, spec: TaskSpec, attempt: int = 0) -> None:
        try:
            await self._run_normal_task_inner(spec, attempt)
        except asyncio.CancelledError:
            # A cancelled dispatcher (io-loop shutdown, or any stray
            # cancellation) previously sailed past `except Exception` and
            # left every return entry unresolved — get() callers then
            # waited out their FULL timeout on an object that could never
            # arrive (the in-suite materialize wedge). Resolve the
            # entries with an error before propagating.
            self._fail_task(spec, serialize_error(exc.RaySystemError(
                f"dispatcher for task {spec.name} was cancelled "
                "(worker shutting down?)")))
            self._release_deps(spec)
            raise
        except Exception as e:  # noqa: BLE001 — submission machinery crashed
            self._fail_task(spec, serialize_error(e))
            # Every failure path must drop the task's pinned dependency
            # refs or repeated failures (e.g. runtime_env setup errors)
            # pin objects in the store forever.
            self._release_deps(spec)

    async def _run_normal_task_inner(self, spec: TaskSpec, attempt: int) -> None:
        dep_error = await self._resolve_deps(spec)
        if dep_error is not None:
            self._fail_task(spec, dep_error)
            self._release_deps(spec)
            return

        reexported = False
        # Memory-monitor preemptions get their own small retry budget:
        # the raylet rescheduled the task on purpose (PREEMPT_RESCHEDULE),
        # so even a max_retries=0 task reruns instead of failing for an
        # infra decision it didn't cause.
        preempt_retries = 0
        while True:
            if spec.task_id.binary() in self._cancelled_tasks:
                self._fail_task(spec, serialize_error(
                    exc.TaskCancelledError(f"task {spec.name} was cancelled")))
                self._release_deps(spec)
                return
            outcome = await self._dispatch_task(spec)
            if outcome is None:
                self._fail_task(spec, serialize_error(exc.RaySystemError(
                    f"could not lease a worker for task {spec.name} "
                    f"(resources {spec.resources.to_dict()} infeasible or "
                    "timeout)")))
                self._release_deps(spec)
                return
            if outcome is _CANCELLED_SENTINEL:
                self._fail_task(spec, serialize_error(
                    exc.TaskCancelledError(f"task {spec.name} was cancelled")))
                self._release_deps(spec)
                return
            if isinstance(outcome, _WorkerCrashed):
                if spec.task_id.binary() in self._cancelled_tasks:
                    # force-cancel kills the executing worker; that death
                    # is the cancellation, not a crash to retry.
                    self._fail_task(spec, serialize_error(
                        exc.TaskCancelledError(
                            f"task {spec.name} was cancelled (force)")))
                    self._release_deps(spec)
                    return
                if attempt < spec.max_retries:
                    attempt += 1
                    self._report_task_retry(spec, attempt,
                                            "worker crashed")
                    await asyncio.sleep(min(0.05 * (2 ** attempt), 2.0))
                    continue
                err_cls, detail, info = await self._describe_worker_death(
                    outcome)
                if info.get("preempted") and preempt_retries < 3:
                    preempt_retries += 1
                    self._report_task_retry(
                        spec, attempt, "worker preempted by the memory "
                        "monitor (PREEMPT_RESCHEDULE)")
                    await asyncio.sleep(
                        min(0.05 * (2 ** preempt_retries), 2.0))
                    continue
                self._fail_task(spec, serialize_error(err_cls(
                    f"worker died while executing task {spec.name} "
                    f"(after {attempt} retries){detail}")))
                self._release_deps(spec)
                return
            reply = outcome
            if reply.get("app_error") is not None:
                if (not reexported
                        and b"not found in the GCS function table"
                        in reply["app_error"]
                        and await self._maybe_reexport(
                            spec.function.function_hash)):
                    reexported = True
                    # A bounced GCS lost the export; it's restored — retry
                    # without burning a user-visible attempt.
                    continue
                if (spec.task_id.binary() not in self._cancelled_tasks
                        and self._should_retry_app_error(
                            spec, reply["app_error"], attempt)):
                    attempt += 1
                    self._report_task_retry(spec, attempt,
                                            "application error")
                    continue
                self._fail_task(spec, reply["app_error"])
                self._release_deps(spec)
                return
            # Result installation is transactional with dep release and
            # the FINISHED event; results above rpc_put_max_bytes take
            # the sync plasma path (everything smaller is pipelined via
            # _async_plasma_put), a local-socket RPC to the co-located
            # raylet.
            self._accept_results(spec, reply)  # graftlint: disable=async-blocking-transitive
            self._release_deps(spec)
            self._record_task_event(spec, "FINISHED")
            return

    def _report_task_retry(self, spec: TaskSpec, attempt: int,
                           reason: str) -> None:
        """Fire-and-forget TASK_RETRY cluster event; forensics must never
        slow down or fail the retry itself."""
        async def _send():
            try:
                await self.gcs.acall(
                    "report_cluster_event", event_type="TASK_RETRY",
                    message=f"task {spec.name} attempt {attempt}/"
                            f"{spec.max_retries} retrying: {reason}",
                    extra={"task_id": spec.task_id.hex(),
                           "attempt": attempt, "reason": reason},
                    timeout=10)
            except Exception:
                pass

        try:
            asyncio.get_running_loop().create_task(_send())
        except RuntimeError:
            pass

    async def _describe_worker_death(self, outcome: "_WorkerCrashed"):
        """Forensics for a final (retries-exhausted) worker death: exit
        classification + last log lines from the lessor raylet, recent
        same-node cluster events from the GCS. The lessor being
        unreachable while the GCS says its node is DEAD classifies as
        NODE_DEATH. Returns (exception_class, message_suffix, info) —
        the retry loop reads info["preempted"] to rerun memory-monitor
        preemptions instead of failing them."""
        from ray_tpu_torch.observability import events as _events

        err_cls = exc.WorkerCrashedError
        detail = ""
        info: dict = {}
        node_hex = None
        try:
            info = await outcome.lessor.acall(
                "get_worker_exit_info",
                worker_id=outcome.worker_id, timeout=5) or {}
            if not info.get("exit_type"):
                # The raylet's reaper polls every 200ms; the crash was
                # noticed here first. One short retry for the verdict.
                await asyncio.sleep(0.5)
                info = await outcome.lessor.acall(
                    "get_worker_exit_info",
                    worker_id=outcome.worker_id, timeout=5) or {}
            node_hex = info.get("node_id")
        except Exception:
            try:
                nodes = await self.gcs.acall("get_all_nodes", timeout=5)
                lessor_addr = (outcome.lessor.host, outcome.lessor.port)
                for n in nodes:
                    if tuple(n.get("addr") or ()) == lessor_addr:
                        node_hex = n["node_id"].hex()
                        if n.get("state") == "DEAD":
                            info = {"exit_type": "NODE_DEATH"}
                        break
            except Exception:
                pass
        if info.get("oom_killed"):
            err_cls = exc.OutOfMemoryError
            detail = " (OOM-killed by the node memory monitor)"
            info.setdefault("exit_type", "OOM_KILLED")
        elif info.get("preempted"):
            detail = (" (preemptively rescheduled by the node memory "
                      "monitor)")
            info.setdefault("exit_type", "PREEMPT_RESCHEDULE")
        elif info.get("exit_type") == "NODE_DEATH":
            detail = " (the node hosting the worker died)"
        recent = None
        if node_hex:
            try:
                recent = await self.gcs.acall(
                    "list_cluster_events", node_id=node_hex, limit=5,
                    timeout=5)
            except Exception:
                recent = None
        return (err_cls, detail + _events.format_exit_detail(info, recent),
                info)

    def _should_retry_app_error(self, spec: TaskSpec, payload: bytes,
                                attempt: int) -> bool:
        if attempt >= spec.max_retries or spec.retry_exceptions is False:
            return False
        if spec.retry_exceptions is True:
            return True
        try:
            cause, _ = deserialize_error(payload)
            return isinstance(cause, tuple(spec.retry_exceptions))
        except Exception:
            return False

    def _lease_key(self, spec: TaskSpec, demand: ResourceSet) -> str:
        s = spec.scheduling
        return repr((sorted(demand.to_dict().items()), s.kind, s.node_id,
                     s.soft, s.placement_group_id, s.bundle_index,
                     sorted(s.hard_labels.items()),
                     sorted(s.soft_labels.items()), spec.runtime_env,
                     spec.job_id.binary()))

    def _lease_state(self, key: str) -> "_LeaseState":
        st = self._lease_pool.get(key)
        if st is None:
            st = self._lease_pool[key] = _LeaseState()
        return st

    def _hand_lease(self, key: str, st: "_LeaseState", lease,
                    reused: bool = False) -> None:
        lease["_idle_since"] = time.monotonic()
        lease["_reused"] = reused
        if reused:
            st.idle.append(lease)
        else:
            # Fresh grants pair before recycled leases: a grant was issued
            # *for* a specific waiter by the cluster scheduler; honoring it
            # first keeps placement decisions with the raylet.
            st.idle.appendleft(lease)
        st.event.set()
        if not self._lease_pool_sweeper_started:
            self._lease_pool_sweeper_started = True
            spawn_task(self._lease_pool_sweeper())

    async def _lease_pool_sweeper(self):
        """Give leases back to their raylet after a short idle window so
        held workers never starve other owners for long."""
        idle_ttl = 0.5
        while not self._dead:
            await asyncio.sleep(0.1)
            now = time.monotonic()
            for key, st in list(self._lease_pool.items()):
                while st.idle and now - st.idle[0]["_idle_since"] > idle_ttl:
                    lease = st.idle.popleft()
                    try:
                        await lease["_lessor"].acall(
                            "return_worker", worker_id=lease["worker_id"],
                            kill=False,
                            lease_token=lease.get("lease_token"),
                            timeout=10)
                    except Exception:
                        pass
                if (not st.idle and not st.waiters and not st.inflight
                        and not st.pushing):
                    self._lease_pool.pop(key, None)
                    st.event.set()  # wake the dispatcher so it can exit

    async def _dispatch_task(self, spec: TaskSpec):
        """Owner-side lease manager + dispatcher (reference: the direct
        task submitter's leased-worker cache and pipelined lease requests
        in `normal_task_submitter`, `lease_policy.h:56`). Tasks with the
        same scheduling shape share a queue: granted or finished-with
        leases are handed straight to the next waiters — batched into one
        push frame when the function is measured-short — and raylet round
        trips happen only to grow the working set.

        Returns the push reply dict, or None (no lease), or the
        _CANCELLED_SENTINEL, or a _WorkerCrashed instance.
        """
        demand = spec.resources
        strategy = spec.scheduling
        if strategy.kind == "PLACEMENT_GROUP":
            demand = await self._pg_demand(strategy, demand)
            if demand is None:
                return None
        key = self._lease_key(spec, demand)
        st = self._lease_state(key)
        fut = asyncio.get_running_loop().create_future()
        st.waiters.append((spec, fut))
        st.event.set()
        if not st.dispatcher_started:
            st.dispatcher_started = True
            spawn_task(self._lease_dispatcher(key, st))
        self._spawn_lease_requesters(key, st, demand, strategy,
                                     spec.runtime_env)
        # No deadline here: a saturated-but-feasible cluster queues tasks
        # indefinitely (reference pending-task-queue semantics); only the
        # requester resolves a waiter with None when demand stays
        # infeasible past the lease deadline. The periodic wakeup just
        # re-ensures requesters exist (they exit when waiters drain).
        while True:
            done, _ = await asyncio.wait([fut], timeout=30)
            if done:
                return fut.result()
            self._spawn_lease_requesters(key, st, demand, strategy,
                                         spec.runtime_env)

    async def _lease_dispatcher(self, key: str, st: "_LeaseState"):
        """Single consumer per scheduling shape: pairs idle leases with
        waiting tasks and fires batch pushes."""
        while not self._dead:
            try:
                await asyncio.wait_for(st.event.wait(), 30)
            except asyncio.TimeoutError:
                if self._lease_pool.get(key) is not st:
                    return  # state was retired by the sweeper
                continue
            st.event.clear()
            if self._lease_pool.get(key) is not st:
                return
            while st.idle and st.waiters:
                lease = st.idle.popleft()
                if (lease.get("_reused") and st.remote_pending
                        and not self._live_waiters_at_least(
                            st, st.remote_pending + 1)):
                    # Every remaining waiter has a grant pending on another
                    # node (spilled request parked at a remote raylet).
                    # Reusing this finished lease would serialize work on
                    # this node while that node idles; park it instead —
                    # the sweeper returns it if the grants land first.
                    st.idle.appendleft(lease)
                    break
                batch = self._take_batch(st)
                if not batch:
                    st.idle.appendleft(lease)
                    break
                st.pushing += 1
                spawn_task(
                    self._push_batch(key, st, lease, batch))

    @staticmethod
    def _live_waiters_at_least(st: "_LeaseState", k: int) -> bool:
        """True if >= k waiters are still live (future not done). Bounded
        scan: stops at k, so callers comparing against small thresholds
        (inflight caps, remote_pending) stay O(k) on deep queues."""
        if k <= 0:
            return True
        n = 0
        for _spec, fut in st.waiters:
            if not fut.done():
                n += 1
                if n >= k:
                    return True
        return False

    def _take_batch(self, st: "_LeaseState"):
        """Pop the next push batch: one task normally; up to 8 of the same
        function when its measured duration says batching can't hurt
        (amortizes per-frame cost without timesharing long tasks)."""
        batch = []
        while st.waiters and len(batch) < 8:
            spec, fut = st.waiters[0]
            if fut.done():
                st.waiters.popleft()
                continue
            if spec.task_id.binary() in self._cancelled_tasks:
                st.waiters.popleft()
                fut.set_result(_CANCELLED_SENTINEL)
                continue
            if batch:
                if (spec.function.function_hash
                        != batch[0][0].function.function_hash):
                    break
            batch.append(st.waiters.popleft())
            ema = self._fn_dur_ema.get(spec.function.function_hash)
            if ema is None or ema >= 0.005 or spec.num_returns < 0:
                break  # unknown / long / generator: one task per lease
        return batch

    async def _push_batch(self, key: str, st: "_LeaseState", lease, batch):
        worker_addr = tuple(lease["worker_addr"])
        client = self._client_for(worker_addr)
        phases_on = GlobalConfig.sched_phase_instrumentation
        for spec, fut in batch:
            self._inflight_push[spec.task_id.binary()] = worker_addr
            if len(batch) > 1:
                self._inflight_futs[spec.task_id.binary()] = fut
            if phases_on:
                # The lease is paired with this waiter right here —
                # everything before is scheduling (queueing + raylet
                # lease grant), everything after is dispatch.
                now = time.time()
                spec.phase_ts = dict(spec.phase_ts or {})
                spec.phase_ts["LEASE_GRANTED"] = now
                self._record_task_event(spec, "LEASE_GRANTED", ts=now)
            # Push-time RUNNING: live and crashed tasks must render a
            # task bar even if no reply ever arrives; on reply the
            # worker's exec-start-accurate RUNNING supersedes it
            # (timeline keeps the newest event per state).
            self._record_task_event(spec, "RUNNING",
                                    worker_addr=list(worker_addr))
        try:
            try:
                if len(batch) == 1:
                    replies = [await client.acall(
                        "push_task", spec=batch[0][0],
                        gpu_ids=lease.get("gpu_ids", []))]
                else:
                    replies = await client.acall(
                        "push_tasks", specs=[s for s, _ in batch],
                        gpu_ids=lease.get("gpu_ids", []))
            except (ConnectionLost, OSError):
                for spec, fut in batch:
                    self._inflight_push.pop(spec.task_id.binary(), None)
                    self._inflight_futs.pop(spec.task_id.binary(), None)
                    if not fut.done():
                        fut.set_result(_WorkerCrashed(lease["worker_id"],
                                                      lease["_lessor"]))
                await self._discard_lease(lease)
                st.event.set()
                return
            except Exception as e:  # noqa: BLE001 — e.g. RpcError
                # Unknown failure mode: fail the tasks with the real error
                # (not a bogus lease timeout) and return the worker killed
                # — its state is unknowable.
                for spec, fut in batch:
                    self._inflight_push.pop(spec.task_id.binary(), None)
                    self._inflight_futs.pop(spec.task_id.binary(), None)
                    if not fut.done():
                        fut.set_exception(e)
                await self._discard_lease(lease)
                st.event.set()
                return
            for (spec, fut), reply in zip(batch, replies):
                self._inflight_push.pop(spec.task_id.binary(), None)
                self._inflight_futs.pop(spec.task_id.binary(), None)
                wphases = (reply.pop("phases", None)
                           if isinstance(reply, dict) else None)
                if phases_on and wphases:
                    self._record_reply_phases(spec, wphases, worker_addr)
                dur = (reply.pop("dur", None)
                       if isinstance(reply, dict) else None)
                if dur is not None:
                    h = spec.function.function_hash
                    prev = self._fn_dur_ema.get(h)
                    self._fn_dur_ema[h] = (dur if prev is None
                                           else 0.7 * prev + 0.3 * dur)
                if not fut.done():
                    fut.set_result(reply)
            self._hand_lease(key, st, lease, reused=True)
        finally:
            st.pushing -= 1

    async def _discard_lease(self, lease) -> None:
        try:
            await lease["_lessor"].acall(
                "return_worker", worker_id=lease["worker_id"],
                kill=True, lease_token=lease.get("lease_token"),
                timeout=10)
        except Exception:
            pass

    def _spawn_lease_requesters(self, key, st: "_LeaseState", demand,
                                strategy, runtime_env) -> None:
        # One in-flight raylet request per unserved waiter, capped — the
        # requests pipeline through the raylet's queue and grants go to
        # whichever waiter is first.
        want = min(len(st.waiters), 16)
        while st.inflight < want:
            st.inflight += 1
            spawn_task(self._lease_requester(
                key, st, demand, strategy, runtime_env))

    async def _autoscaler_running(self) -> bool:
        try:
            return bool(await self.gcs.acall("autoscaler_running",
                                             timeout=5))
        except Exception:
            return False

    async def _lease_requester(self, key, st: "_LeaseState", demand,
                               strategy, runtime_env):
        client = self.raylet
        deadline = time.monotonic() + GlobalConfig.worker_lease_timeout_ms / 1000
        fast_timeouts = 0
        try:
            while st.waiters and not self._dead:
                if not self._live_waiters_at_least(
                        st, len(st.idle) + st.inflight):
                    # Remaining waiters are already covered by idle leases
                    # (e.g. the grant this requester just handed over, not
                    # yet consumed by the dispatcher) or by the other
                    # in-flight requests (e.g. one parked at a spilled-to
                    # raylet). A surplus request here would lease a worker
                    # nobody will use — or steal the waiter back from an
                    # idle remote node.
                    break
                remote = client is not self.raylet
                st.remote_pending += remote
                req_start = time.monotonic()
                try:
                    reply = await client.acall(
                        "request_worker_lease",
                        demand=demand.to_dict(), job_id=self.job_id.binary(),
                        strategy_kind="DEFAULT" if strategy.kind ==
                        "PLACEMENT_GROUP" else strategy.kind,
                        strategy_node=strategy.node_id, soft=strategy.soft,
                        hard_labels=strategy.hard_labels,
                        soft_labels=strategy.soft_labels,
                        lease_timeout=25.0, runtime_env=runtime_env,
                        owner_id=self.worker_id.binary(),
                        timeout=30.0)
                except (ConnectionLost, OSError):
                    await asyncio.sleep(0.2)
                    client = self.raylet
                    continue
                finally:
                    if remote:
                        st.remote_pending -= 1
                        st.event.set()  # a parked reused lease may now pair
                if reply.get("timeout") and (
                        time.monotonic() - req_start < 5.0):
                    # The raylet gave up on a pop almost immediately: the
                    # node can't spawn workers at all (fork failure). A
                    # saturated-but-healthy cluster instead parks us the
                    # full lease window, so rapid timeouts are a real
                    # failure signal — bound them rather than hot-loop.
                    fast_timeouts += 1
                    if fast_timeouts >= 20:
                        while st.waiters:
                            _spec, fut = st.waiters.popleft()
                            if not fut.done():
                                fut.set_result(None)
                                break
                        fast_timeouts = 0
                    await asyncio.sleep(0.2)
                    continue
                if not reply.get("timeout"):
                    fast_timeouts = 0
                elif remote:
                    # Full-window park timeout on a spilled-to node: go back
                    # to the local raylet to re-evaluate placement instead of
                    # re-parking on a node that may no longer be the pick.
                    client = self.raylet
                if reply.get("granted"):
                    reply["_lessor"] = client
                    self._hand_lease(key, st, reply)
                    client = self.raylet  # next grant starts local again
                    continue
                if reply.get("spillback_to"):
                    client = self._raylet_client(tuple(reply["spillback_to"]))
                    continue
                if reply.get("env_setup_error"):
                    from ray_tpu_torch.runtime_env.manager import (
                        RuntimeEnvSetupError,
                    )

                    while st.waiters:
                        _spec, fut = st.waiters.popleft()
                        if not fut.done():
                            fut.set_exception(RuntimeEnvSetupError(
                                reply["env_setup_error"]))
                            break
                    await asyncio.sleep(0.05)
                    continue
                if reply.get("infeasible"):
                    # Infeasible *now* may become feasible (node still
                    # joining, PG bundle resources propagating); back off
                    # and retry until the lease deadline, as the
                    # reference's infeasible queue does. A feasible-but-
                    # busy cluster instead queues indefinitely inside the
                    # raylet (a saturated cluster must never fail tasks
                    # with a timeout).
                    if time.monotonic() >= deadline:
                        # Past the deadline a task waits on only for the
                        # node a running autoscaler is adding (the raylet
                        # reports its demand), as an actor does.
                        if not await self._autoscaler_running():
                            while st.waiters:
                                _spec, fut = st.waiters.popleft()
                                if not fut.done():
                                    fut.set_result(None)
                                    break
                        deadline = (time.monotonic()
                                    + GlobalConfig.worker_lease_timeout_ms
                                    / 1000)
                    await asyncio.sleep(0.2)
                    continue
                await asyncio.sleep(0.05)
        finally:
            st.inflight -= 1

    async def _pg_demand(self, strategy: SchedulingStrategySpec,
                         demand: ResourceSet) -> Optional[ResourceSet]:
        reply = await self.gcs.acall("wait_placement_group_ready",
                                     pg_id=strategy.placement_group_id,
                                     wait_timeout=55.0, timeout=60.0)
        if reply.get("state") != "CREATED":
            return None
        from ray_tpu_torch._private.resources import pg_task_demand

        return pg_task_demand(demand, strategy.placement_group_id.hex(),
                              strategy.bundle_index)

    def _accept_results(self, spec: TaskSpec, reply: Dict[str, Any]) -> None:
        if spec.num_returns < 0:
            self._accept_generator_results(spec, reply)
            return
        for outer, inners in (reply.get("contained") or {}).items():
            # Return values embedding refs: we own the return object, so
            # we hold the object-keyed borrow on each inner ref until the
            # return object is freed.
            self._adopt_contained(outer, inners)
        for oid, kind, payload in reply["results"]:
            if kind == "inline":
                self._complete_object(oid, inline=payload)
            elif kind == "plasma":
                self.reference_counter.add_location(oid, payload)
                self._complete_object(oid, in_plasma=True)
            elif kind == "error":
                self._complete_object(oid, error=payload)

    def _accept_generator_results(self, spec: TaskSpec,
                                  reply: Dict[str, Any]) -> None:
        tid = spec.task_id.binary()
        count = reply.get("generator_count", len(reply["results"]))
        for i, item in enumerate(reply["results"]):
            self._on_generator_item(tid, i, item)  # no-op if already pushed
        state = self._generators.setdefault(tid, _GeneratorState())
        with state.cond:
            state.total = count
            state.cond.notify_all()
        # The generator ref (index 1) resolves to the list of item refs
        # (num_returns="dynamic" semantics).
        refs = [ObjectRef(spec.generator_item_id(i).binary(), self.addr,
                          self.worker_id.binary()) for i in range(count)]
        self._store_value(spec.return_ids()[0].binary(), refs)

    def _fail_task(self, spec: TaskSpec, error_payload: bytes) -> None:
        self._record_task_event(spec, "FAILED")
        for rid in spec.return_ids():
            self._complete_object(rid.binary(), error=error_payload)
        state = self._generators.get(spec.task_id.binary())
        if state is not None:
            with state.cond:
                state.error = error_payload
                state.cond.notify_all()

    def _release_deps(self, spec: TaskSpec) -> None:
        # Lineage pinning (reference: lineage pinning in reference_count.cc):
        # while the task's spec is kept for reconstruction, its args must
        # stay resolvable — their deps are released only when the lineage is
        # dropped (_drop_lineage), not when the task completes.
        if spec.task_id.binary() in self._lineage:
            return
        for arg in spec.args:
            if arg.is_ref and tuple(arg.owner_addr) == self.addr:
                self.reference_counter.remove_task_dependency(arg.object_id)

    # ======================================================================
    # Actor submission (owner side)
    # ======================================================================
    def _actor_creation_spec(self, cls_name: str, fn_hash, args, kwargs,
                             options: Dict[str, Any]) -> TaskSpec:
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_creation(actor_id)
        arg_specs, kw_keys = self._serialize_args(args, kwargs)
        resources = _resources_from_options(options)
        return TaskSpec(
            task_id=task_id, job_id=self.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function=FunctionDescriptor("", cls_name, fn_hash),
            args=arg_specs, kwargs_keys=kw_keys, num_returns=0,
            resources=resources, owner_addr=self.addr,
            owner_worker_id=self.worker_id,
            name=options.get("name") or cls_name,
            scheduling=_strategy_from_options(options),
            actor_id=actor_id,
            max_restarts=options.get("max_restarts",
                                     GlobalConfig.actor_max_restarts_default),
            max_task_retries=options.get("max_task_retries", 0),
            max_concurrency=options.get("max_concurrency", 1),
            is_async_actor=options.get("is_async", False),
            is_detached=options.get("lifetime") == "detached",
            actor_name=options.get("name") or "",
            namespace=options.get("namespace") or "default",
            runtime_env=self._prepare_runtime_env(
                options.get("runtime_env")),
        )

    def create_actor(self, cls_payload: bytes, cls_name: str, args, kwargs,
                     options: Dict[str, Any]) -> "Any":
        from ray_tpu_torch.actor import ActorHandle

        fn_hash = self.export_function(cls_payload)
        spec = self._actor_creation_spec(cls_name, fn_hash, args, kwargs,
                                         options)
        reply = self.gcs.call("register_actor", spec=spec)
        if reply.get("error"):
            if options.get("get_if_exists") and reply.get("existing_actor_id"):
                return self.get_actor(options["name"],
                                      options.get("namespace") or "default")
            raise ValueError(reply["error"])
        if not spec.is_detached:
            # Non-detached actors die when all local handles go out of scope.
            self.actor_handles.mark_created(spec.actor_id.binary())
        return ActorHandle(spec.actor_id.binary(), cls_name,
                           options.get("max_task_retries", 0))

    def create_actors(self, cls_payload: bytes, cls_name: str, count: int,
                      args, kwargs, options: Dict[str, Any]) -> List["Any"]:
        """Create `count` identical actors with ONE batched GCS
        registration RPC (the per-member round-trip was the dominant
        serialized cost of a large gang/fleet bring-up)."""
        from ray_tpu_torch.actor import ActorHandle

        fn_hash = self.export_function(cls_payload)  # exported once
        specs = [
            self._actor_creation_spec(cls_name, fn_hash, args, kwargs,
                                      options)
            for _ in range(count)
        ]
        replies = self.gcs.call("register_actors", specs=specs)
        handles = []
        for spec, reply in zip(specs, replies):
            if reply.get("error"):
                raise ValueError(reply["error"])
            if not spec.is_detached:
                self.actor_handles.mark_created(spec.actor_id.binary())
            handles.append(ActorHandle(spec.actor_id.binary(), cls_name,
                                       options.get("max_task_retries", 0)))
        return handles

    def get_actor(self, name: str, namespace: str = "default"):
        from ray_tpu_torch.actor import ActorHandle

        info = self.gcs.call("get_named_actor", name=name, namespace=namespace)
        if info is None:
            raise ValueError(f"no actor named {name!r} in namespace "
                             f"{namespace!r}")
        return ActorHandle(info["actor_id"], info.get("class_name", "Actor"),
                           0)

    def submit_actor_task(self, actor_id: bytes, method_name: str, args,
                          kwargs, options: Dict[str, Any],
                          max_task_retries: int = 0) -> List[ObjectRef]:
        self.drain_releases()
        task_id = TaskID.for_actor_task(ActorID(actor_id))
        arg_specs, kw_keys = self._serialize_args(args, kwargs)
        num_returns = options.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if isinstance(num_returns, str):
            num_returns = {"dynamic": -1, "streaming": -2}[num_returns]
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, task_type=TaskType.ACTOR_TASK,
            function=FunctionDescriptor("", method_name, ""),
            args=arg_specs, kwargs_keys=kw_keys, num_returns=num_returns,
            resources=ResourceSet({}), owner_addr=self.addr,
            owner_worker_id=self.worker_id,
            name=method_name, actor_id=ActorID(actor_id),
            max_task_retries=max_task_retries,
            concurrency_group=options.get("concurrency_group", ""),
            trace_ctx=_current_wire_trace(),
        )
        refs = []
        for rid in spec.return_ids():
            self.reference_counter.add_owned(rid.binary())
            self._entry(rid.binary())
            refs.append(ObjectRef(rid.binary(), self.addr,
                                  self.worker_id.binary()))
        if num_returns < 0:
            # Streaming item pushes may arrive before this coroutine runs.
            self._generators[task_id.binary()] = _GeneratorState()
        self.io.submit(self._run_actor_task(spec))
        if streaming:
            from ray_tpu_torch._private.object_ref import ObjectRefGenerator

            gen = ObjectRefGenerator(task_id.binary(), self.addr,
                                     self.worker_id.binary())
            gen._ref0 = refs[0]
            return [gen]
        return refs

    def _actor_lock(self, actor_id: bytes) -> asyncio.Lock:
        lock = self._actor_submit_locks.get(actor_id)
        if lock is None:
            lock = self._actor_submit_locks[actor_id] = asyncio.Lock()
        return lock

    # -- ordered actor submission -------------------------------------------
    # One sender coroutine per actor drains queued calls, looks up the
    # actor's address once per drained group and sends each call as a
    # frame of its own, back to back (reference analogue: the direct actor
    # transport's ordered send queue in core_worker, one PushTask per
    # call). A frame holding several calls is answered only when all of
    # them have ended, so a quick call framed with a long one (a serve
    # long poll, a long generation) waited out the long one; one frame a
    # call keeps each reply independent. The single sender also provides
    # the (assign seq, send) ordering the old per-actor lock enforced.
    async def _send_actor_task(self, actor_id: bytes, spec: TaskSpec):
        b = self._actor_batchers.get(actor_id)
        if b is None:
            b = self._actor_batchers[actor_id] = _ActorSendQueue()
            b.task = spawn_task(self._actor_send_loop(actor_id, b))
        fut = asyncio.get_running_loop().create_future()
        b.queue.append((spec, fut))
        b.event.set()
        return await fut

    async def _actor_send_loop(self, actor_id: bytes, b: "_ActorSendQueue"):
        max_batch = 64
        while not self._dead:
            await b.event.wait()
            b.event.clear()
            while b.queue:
                batch = [b.queue.popleft()
                         for _ in range(min(len(b.queue), max_batch))]
                addr = None
                addr_err: Optional[BaseException] = None
                # NOTHING has been sent yet for this batch (no seqs
                # burned), so retrying the address lookup is always
                # safe — a single GCS blip must not fail calls from
                # max_task_retries=0 callers who cannot retry.
                lookup_deadline = (time.monotonic()
                                   + GlobalConfig.actor_unreachable_timeout_s)
                attempt = 0
                while True:
                    try:
                        addr = await self._actor_addr(actor_id)
                        addr_err = None
                        break
                    except Exception as e:  # noqa: BLE001 — GCS outage
                        addr_err = e
                        if (self._dead
                                or time.monotonic() >= lookup_deadline):
                            break
                        attempt += 1
                        await asyncio.sleep(min(1.0, 0.2 * attempt))
                if addr_err is not None:
                    # Lookup deadline exhausted: resolve the batch with
                    # the error and keep the loop alive so later calls
                    # don't enqueue onto a dead sender forever.
                    err = addr_err if isinstance(
                        addr_err, (ConnectionLost, OSError)) \
                        else ConnectionLost(repr(addr_err))
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(type(err)(str(err)))
                    continue
                if addr is None:
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(_ActorAddrUnavailable())
                    continue
                # Pipelined: frames go out while earlier replies are in
                # flight; the worker starts tasks in seq order whatever
                # order their frames arrive in, so per-caller FIFO holds.
                for item in batch:
                    seq = self._actor_seq[actor_id]
                    self._actor_seq[actor_id] += 1
                    spawn_task(self._deliver_actor_task(
                        actor_id, item, seq, addr))

    async def _deliver_actor_task(self, actor_id, item, seq, addr):
        """Send one call's frame, resending the SAME sequence number on
        transient connection failures while the actor process is alive
        with an unchanged incarnation. Two reasons this retry must live
        HERE: (a) a connect blip to a live actor is a network event, not
        an actor death — callers with max_task_retries=0 must not see
        ActorDiedError for it; (b) seqs are burned at assignment, and a
        dropped frame would leave a permanent gap that wedges the
        worker's in-order start queue for every later call from this
        caller."""
        spec, fut = item
        prev_inc = self._actor_incarnation.get(actor_id, 0)
        # Deadline, not a small attempt count: on an oversubscribed host
        # a healthy actor worker can be CPU-starved past the 10 s
        # connect timeout many times in a row (observed: a 500-actor
        # readiness sweep after a 1M-task drain). Resending the SAME
        # seqs is safe for any duration — the worker dedups — so
        # persistence costs nothing semantically, while giving up early
        # surfaces a bogus failure for a live actor.
        deadline = (time.monotonic()
                    + GlobalConfig.actor_unreachable_timeout_s)
        attempt = 0
        while True:
            if addr is None:
                if not fut.done():
                    fut.set_exception(_ActorAddrUnavailable())
                return
            client = self._client_for(addr)
            try:
                reply = await client.acall(
                    "push_actor_task", spec=spec, seq=seq,
                    caller_id=self.worker_id.binary())
            except (ConnectionLost, OSError) as e:
                self._actor_addr_cache.pop(actor_id, None)
                gcs_down = False
                try:
                    info = await self.gcs.acall(
                        "get_actor_info", actor_id=actor_id, timeout=30)
                except Exception:
                    # GCS unreachable: the actor's fate is UNKNOWN, not
                    # bad — resending the same seqs is safe regardless,
                    # so keep retrying under the deadline instead of
                    # converting a GCS blip into a hard task failure
                    # for max_task_retries=0 callers.
                    info = None
                    gcs_down = True
                if ((gcs_down or (info and info.get("state") == "ALIVE"
                                  and info.get("restarts_used",
                                               0) == prev_inc))
                        and time.monotonic() < deadline):
                    # Same process, still alive (or fate unknowable):
                    # resend the same frame (the worker dedups seqs it
                    # already started).
                    attempt += 1
                    await asyncio.sleep(min(1.0, 0.2 * attempt))
                    if info and info.get("addr"):
                        addr = tuple(info["addr"])
                    elif not gcs_down:
                        try:
                            addr = await self._actor_addr(actor_id)
                        except Exception:
                            pass  # keep the old addr; retry covers it
                    # gcs_down: keep the old addr — a lookup would just
                    # raise again, and an escaped exception here would
                    # orphan every future in the batch.
                    continue
                print(f"[worker] actor delivery giving up after "
                      f"{attempt} resends: state="
                      f"{(info or {}).get('state')} inc="
                      f"{(info or {}).get('restarts_used')} "
                      f"err={type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
                if not fut.done():
                    fut.set_exception(ConnectionLost(str(e)))
                return
            except Exception as e:  # noqa: BLE001 — RpcError etc.: a
                # fire-and-forget task swallowing this would leave every
                # caller future pending forever; fail the calls instead.
                if not fut.done():
                    fut.set_exception(e)
                return
            if not fut.done():
                fut.set_result(reply)
            return

    async def _run_actor_task(self, spec: TaskSpec) -> None:
        self.actor_handles.task_submitted(spec.actor_id.binary())
        try:
            await self._run_actor_task_inner(spec)
        except Exception as e:  # noqa: BLE001
            self._fail_task(spec, serialize_error(e))
            self._release_deps(spec)
        finally:
            self.actor_handles.task_completed(spec.actor_id.binary())

    async def _run_actor_task_inner(self, spec: TaskSpec) -> None:
        actor_id = spec.actor_id.binary()
        dep_error = await self._resolve_deps(spec)
        if dep_error is not None:
            self._fail_task(spec, dep_error)
            self._release_deps(spec)
            return
        attempt = 0
        while True:
            try:
                reply = await self._send_actor_task(actor_id, spec)
            except _ActorAddrUnavailable:
                self._fail_task(spec, serialize_error(exc.ActorDiedError(
                    f"actor {spec.actor_id} is dead")))
                self._release_deps(spec)
                return
            except (ConnectionLost, OSError):
                self._actor_addr_cache.pop(actor_id, None)
                # The GCS learns of the death via the raylet's worker-exit
                # report, which races this query: an immediate read can
                # return stale ALIVE with an unchanged incarnation and
                # misclassify a plain death as "restarted". Poll until the
                # state moves off the pre-failure snapshot (or ~5s).
                prev_inc = self._actor_incarnation.get(actor_id, 0)
                info = None
                for _ in range(25):
                    info = await self.gcs.acall("get_actor_info",
                                                actor_id=actor_id,
                                                timeout=30)
                    state = (info or {}).get("state")
                    if state != "ALIVE" or (info or {}).get(
                            "restarts_used", 0) != prev_inc:
                        break
                    await asyncio.sleep(0.2)
                state = (info or {}).get("state")
                # Sequence numbers reset only when the actor PROCESS was
                # replaced (incarnation bump), not on a transient network
                # drop to a live actor — the live process keeps its
                # expected_seq counter.
                new_inc = (info or {}).get("restarts_used", 0)
                if new_inc != self._actor_incarnation.get(actor_id, 0):
                    self._actor_incarnation[actor_id] = new_inc
                    self._actor_seq.pop(actor_id, None)
                if state in ("RESTARTING", "PENDING_CREATION", "ALIVE") and (
                        spec.max_task_retries != 0 and
                        (spec.max_task_retries == -1
                         or attempt < spec.max_task_retries)):
                    attempt += 1
                    continue
                if state == "ALIVE":
                    if new_inc == prev_inc:
                        # Never restarted: the delivery layer exhausted
                        # its (long) same-seq resend deadline against a
                        # live but unreachable actor. Say so — calling
                        # this a restart sent earlier debugging down the
                        # wrong path entirely.
                        self._fail_task(spec, serialize_error(
                            exc.ActorUnavailableError(
                                f"actor alive but unreachable while "
                                f"executing {spec.name}: same-seq "
                                f"delivery resends exhausted their "
                                f"deadline (actor_unreachable_timeout_s="
                                f"{GlobalConfig.actor_unreachable_timeout_s}"
                                f" per stage — address lookup and frame "
                                f"delivery each); set max_task_retries "
                                f"to retry automatically")))
                    else:
                        # Actor restarted but this call isn't retryable.
                        self._fail_task(spec, serialize_error(
                            exc.ActorUnavailableError(
                                f"actor restarted while executing "
                                f"{spec.name}; set max_task_retries to "
                                f"retry automatically")))
                else:
                    self._fail_task(spec, serialize_error(exc.ActorDiedError(
                        f"actor died while executing {spec.name}: "
                        f"{(info or {}).get('death_cause')}")))
                self._release_deps(spec)
                return
            if reply.get("app_error") is not None:
                self._fail_task(spec, reply["app_error"])
            else:
                # Same contract as the normal-task path: install results
                # before releasing deps; only >rpc_put_max_bytes results
                # hit the sync plasma leaf.
                self._accept_results(spec, reply)  # graftlint: disable=async-blocking-transitive
            self._release_deps(spec)
            return

    async def _actor_addr(self, actor_id: bytes) -> Optional[Tuple[str, int]]:
        addr = self._actor_addr_cache.get(actor_id)
        if addr is not None:
            return addr
        while True:
            reply = await self.gcs.acall("wait_actor_ready",
                                         actor_id=actor_id,
                                         wait_timeout=55.0, timeout=60.0)
            state = reply.get("state")
            if state == "ALIVE":
                addr = tuple(reply["addr"])
                self._actor_addr_cache[actor_id] = addr
                return addr
            if state == "DEAD" or reply.get("error") == "unknown actor":
                return None
            # PENDING_CREATION / RESTARTING / long-poll window expired:
            # creation backlog (e.g. a 500-actor burst waiting on worker
            # spawns) is not death — calls to a pending actor block until
            # it comes up, as the reference's direct actor transport does.

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        self.gcs.call("kill_actor", actor_id=actor_id, no_restart=no_restart)

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        """Cancel a task: pre-dispatch it simply never runs; a RUNNING task
        is interrupted on its executing worker (async exception; `force=`
        kills the worker process — reference `CancelTask` force-kill path,
        `core_worker.proto:425`)."""
        tid = ObjectID(ref.binary()).task_id()
        task_id = tid.binary()
        self._cancelled_tasks.add(task_id)
        actor_id = tid.actor_id()
        addr = self._inflight_push.get(task_id)
        if addr is None and not actor_id.is_nil():
            # Actor task: its executing worker is the actor's worker.
            addr = self._actor_addr_cache.get(actor_id.binary())
        if addr is None:
            return

        async def _cancel_running():
            try:
                await self._client_for(addr).acall(
                    "cancel_task", task_id=task_id, force=force, timeout=5)
            except Exception:
                pass

        self.io.submit(_cancel_running())

    # ======================================================================
    # Execution side (RPC handlers)
    # ======================================================================
    async def _h_stack_dump(self):
        """All-thread stack traces (reference: the dashboard's py-spy
        dump route, `profile_manager.py:188` — here via sys._current
        _frames, no external tool). Returns both the structured
        per-thread rows (``threads``) and the joined text blob
        (``stacks``, the shape the dashboard prints)."""
        from ray_tpu_torch.observability import profiling as _profiling

        threads = _profiling.capture_thread_stacks()
        return {"pid": os.getpid(),
                "worker_id": self.worker_id.hex(),
                "threads": threads,
                "stacks": _profiling.format_thread_stacks(threads)}

    async def _h_dump_stacks(self):
        """`ray stack` RPC name (the raylet fans this out per node)."""
        return await self._h_stack_dump()

    async def _h_profile(self, duration_s=5.0, interval_ms=None, hz=None):
        """Wall-clock sampling profile over a StackSampler daemon
        thread: per-thread folded-stack counts + flamegraph.pl text.
        The event loop stays live (the sampler runs on its own thread,
        this handler just sleeps the window), so profiling never blocks
        the worker's task push path. ``interval_ms`` is the legacy
        spelling of the rate; ``hz`` wins when both are given."""
        from ray_tpu_torch.observability import profiling as _profiling

        duration_s = min(float(duration_s),
                         GlobalConfig.profiler_max_duration_s)
        if hz is None and interval_ms is not None:
            hz = 1000.0 / max(float(interval_ms), 1.0)
        sampler = _profiling.StackSampler(hz=hz)
        sampler.start()
        try:
            await asyncio.sleep(duration_s)
        finally:
            result = sampler.stop()
        return {"pid": os.getpid(),
                "worker_id": self.worker_id.hex(),
                "duration_s": result["duration_s"],
                "hz": sampler.hz,
                "samples": result["samples"],
                "dropped": result["dropped"],
                "counts": result["counts"],
                "folded": _profiling.collapse(result["counts"])}


    async def _h_tpu_profile(self, duration_s=1.0, trace_dir=None):
        """Device-trace bracket (torch.profiler, CPU and CUDA activities)
        on this worker; no-op-with-reason where the process holds no CUDA
        context, an error reply while another bracket is open here. Runs
        in an executor thread: the bracket blocks for its window, and the
        event loop must keep serving task pushes."""
        from ray_tpu_torch.observability import profiling as _profiling

        duration_s = min(float(duration_s),
                         GlobalConfig.profiler_max_duration_s)
        try:
            reply = await asyncio.get_running_loop().run_in_executor(
                None, _profiling.capture_tpu_trace, duration_s, trace_dir)
        except RuntimeError as e:
            reply = {"error": str(e)}
        reply["pid"] = os.getpid()
        reply["worker_id"] = self.worker_id.hex()
        return reply

    async def _h_busy_info(self):
        """Liveness+load probe for the raylet's worker-killing policy: a
        leased worker that is actually executing is a better OOM victim
        than one idling in the lease pool (reference:
        `worker_killing_policy.h:34` picks among workers with assigned
        tasks)."""
        return {"executing": len(self._executing_tids)}

    async def _h_ping(self):
        return "pong"

    async def _h_early_task_result(self, task_id, reply, worker_addr=None):
        """Owner-side receiver for a batch sibling's eager completion (see
        _h_push_tasks): resolves the dispatch future early so dependents
        inside the same push batch can make progress. The sender must
        still be the worker this attempt is inflight on — a delayed push
        from a crashed prior attempt must not resolve a retry's future
        with results stored on the dead worker."""
        if (worker_addr is None
                or self._inflight_push.get(task_id) != tuple(worker_addr)):
            return False
        fut = self._inflight_futs.get(task_id)
        if fut is not None and not fut.done():
            fut.set_result(reply)
        return True

    async def _h_wait_object_status(self, object_id, wait_timeout=10.0):
        """Long-poll variant of get_object_status: blocks server-side until
        the object resolves (or the poll window closes), replacing
        borrower-side fixed-rate polling (reference: owner push/long-poll,
        `core_worker.proto:425`). Never fabricates entries: freed/unknown
        ids answer immediately (a freed object must not block the window,
        and phantom entries would leak)."""
        deadline = asyncio.get_running_loop().time() + min(wait_timeout, 30.0)
        while True:
            status = await self._h_get_object_status(object_id)
            if status.get("status") != "pending":
                return status
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                return status
            entry = self._entry(object_id, create=False)
            if entry is None:
                # Unknown here (not yet submitted / already dropped):
                # cheap re-check without creating state.
                await asyncio.sleep(min(0.05, remaining))
                continue
            fut = asyncio.get_running_loop().create_future()
            entry.waiters.append(fut)
            if entry.event.is_set() and not fut.done():
                fut.set_result(None)
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                try:
                    entry.waiters.remove(fut)
                except ValueError:
                    pass

    async def _h_get_object_status(self, object_id):
        entry = self._entry(object_id, create=False)
        if entry is None or not entry.event.is_set():
            if self.reference_counter.is_freed(object_id):
                return {"status": "freed"}
            return {"status": "pending"}
        if entry.error is not None:
            return {"status": "error", "error": entry.error}
        if entry.inline is not None:
            return {"status": "inline", "data": entry.inline}
        return {"status": "plasma",
                "locations": list(self.reference_counter.locations(object_id))}

    async def _h_delete_object_notification(self, object_id):
        mobj = self._mapped.pop(object_id, None)
        if mobj is not None:
            mobj.mark_released()  # the explicit release below covers it
            mobj.close()
            try:
                await self.raylet.acall(
                    "release_object", object_id=object_id,
                    client_id=self.worker_id.binary(), timeout=5)
            except Exception:
                pass
        return True

    async def _h_kill_self(self):
        # Stop accepting work NOW: a task pushed in the window between this
        # reply and os._exit must fail as killed, not silently execute
        # (ray.kill() has already returned to the user by then).
        self._killed = True
        try:  # last-gasp user-metric flush (bounded; best effort)
            from ray_tpu_torch.util.metrics import metric_source, snapshot_records
            recs = snapshot_records()
            if recs:
                await asyncio.wait_for(
                    self.gcs.acall("push_metrics",
                                   source=metric_source(self),
                                   records=recs, timeout=1), 1.0)
        except Exception:
            pass
        asyncio.get_running_loop().call_later(0.02, os._exit, 1)
        return True

    async def _h_cancel_task(self, task_id, force=False):
        self._cancelled_tasks.add(task_id)
        tid_thread = self._executing_tids.get(task_id)
        if tid_thread is not None:
            if force:
                # Reply first, then die: the owner maps the connection loss
                # of a cancelled task to TaskCancelledError, never a retry.
                asyncio.get_running_loop().call_later(0.02, os._exit, 1)
            elif self._thread_task.get(tid_thread) == task_id:
                # The inverse-map check guards against the thread having
                # finished this task and picked up another (async-exc must
                # never land in an innocent task).
                import ctypes

                # Raised at the next bytecode boundary of the executing
                # thread (cannot interrupt a blocking C call — same limit
                # as the reference's non-force cancel).
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(tid_thread),
                    ctypes.py_object(exc.TaskCancelledError))
        return True

    async def _h_push_task(self, spec: TaskSpec, gpu_ids):
        return await asyncio.get_running_loop().run_in_executor(
            self._task_executor, self._execute_task, spec, gpu_ids)

    async def _h_push_tasks(self, specs, gpu_ids):
        """Batched push: executed sequentially under the caller's single
        lease (the owner only batches functions it has measured as short).

        Every completion except the batch's last is ALSO pushed eagerly to
        the owner (`early_task_result`): results that only rode the
        aggregate reply deadlocked any batch where a later task blocks on
        an earlier sibling's output (the owner can't resolve the sibling
        until the whole batch replies, and the batch can't finish until
        the blocked task gets the sibling's value). The aggregate reply
        remains the reliable path; the eager push is fire-and-forget."""
        loop = asyncio.get_running_loop()
        out = []
        for i, spec in enumerate(specs):
            reply = await loop.run_in_executor(
                self._task_executor, self._execute_task, spec, gpu_ids)
            out.append(reply)
            if i < len(specs) - 1 and tuple(spec.owner_addr) != self.addr:
                spawn_task(self._notify_early_result(spec, reply))
        return out

    async def _notify_early_result(self, spec, reply):
        try:
            owner = self._client_for(tuple(spec.owner_addr))
            await owner.acall(
                "early_task_result", task_id=spec.task_id.binary(),
                reply=reply, worker_addr=list(self.addr), timeout=30)
        except Exception:
            pass    # aggregate reply still delivers it

    def _load_function(self, fn_hash: str):
        fn = self._fn_cache.get(fn_hash)
        if fn is None:
            payload = self.gcs.call("kv_get", namespace="fn", key=fn_hash)
            if payload is None:
                raise exc.RaySystemError(
                    f"function {fn_hash} not found in the GCS function table")
            fn = cloudpickle.loads(payload)
            self._fn_cache[fn_hash] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec):
        values = []
        for arg in spec.args:
            if arg.is_ref:
                ref = ObjectRef(arg.object_id, arg.owner_addr, b"",
                                _register=False)
                values.append(self._get_one(ref, timeout=None))
            else:
                values.append(self.serialization.deserialize(
                    memoryview(arg.inline_data)))
        n_kw = len(spec.kwargs_keys)
        if n_kw:
            args = values[:-n_kw]
            kwargs = dict(zip(spec.kwargs_keys, values[-n_kw:]))
        else:
            args, kwargs = values, {}
        return args, kwargs

    def _mark_log_task(self, spec: Optional[TaskSpec],
                       actor_id_hex: str = "",
                       end_tid: Optional[str] = None) -> None:
        """Bracket this process's log streams with task-attribution
        markers (consumed by the raylet's LogMonitor, never echoed) so
        `get_log(task_id=...)` can slice one task's output out of a
        pooled worker's log file. spec=None closes the open span
        (``end_tid`` hex, or the calling thread's current task)."""
        if self.mode != MODE_WORKER:
            return
        from ray_tpu_torch._private.log_monitor import (
            task_end_marker, task_marker,
        )

        if spec is None:
            tid_hex = end_tid or (self._ctx.task_id.hex()
                                  if self._ctx.task_id else None)
            if tid_hex is None:
                return
            line = task_end_marker(tid_hex)
        else:
            line = task_marker(spec.task_id.hex(), actor_id_hex,
                               spec.name)
        for stream in (sys.stdout, sys.stderr):
            try:
                stream.write(line + "\n")
                stream.flush()
            except Exception:
                pass

    def _execute_task(self, spec: TaskSpec, gpu_ids) -> Dict[str, Any]:
        if spec.task_id.binary() in self._cancelled_tasks:
            return {"results": [], "app_error": serialize_error(
                exc.TaskCancelledError(f"task {spec.name} cancelled"))}
        self._mark_log_task(spec)
        self._ctx.task_id = spec.task_id
        self._ctx.task_name = spec.name
        self._ctx.gpu_ids = list(gpu_ids or [])
        from ray_tpu_torch.accelerators.gpu import note_lease

        try:
            note_lease(self._ctx.gpu_ids)
        except RuntimeError as e:
            return {"results": [], "app_error": serialize_error(e)}
        tid = spec.task_id.binary()
        self._executing_tids[tid] = threading.get_ident()
        self._thread_task[threading.get_ident()] = tid
        # Restore the caller's trace context around the task body (the
        # executor thread is reused, so reset in the finally below).
        from ray_tpu_torch.util import tracing as _tracing

        trace_token = _tracing.activate_wire_context(spec.trace_ctx)
        t_start = time.monotonic()
        # Scheduling-phase clocks, stamped on THIS host as execution
        # proceeds and returned in the reply: the owner lands them in
        # the task-event ring and the sched_phase_seconds histogram.
        phases = ({"WORKER_STARTED": time.time()}
                  if GlobalConfig.sched_phase_instrumentation else None)
        try:
            fn = self._load_function(spec.function.function_hash)
            args, kwargs = self._resolve_args(spec)
            if phases is not None:
                phases["ARGS_READY"] = time.time()
                phases["RUNNING"] = time.time()
            result = fn(*args, **kwargs)
            if spec.num_returns < 0:
                results, count = self._store_generator_returns(spec, result)
                return {"results": results, "generator_count": count,
                        "dur": time.monotonic() - t_start,
                        "phases": phases}
            results, contained = self._store_returns(spec, result)
            return {"results": results, "contained": contained,
                    "dur": time.monotonic() - t_start, "phases": phases}
        except Exception as e:  # noqa: BLE001 — application error
            return {"results": [], "app_error": serialize_error(e),
                    "dur": time.monotonic() - t_start, "phases": phases}
        finally:
            _tracing.deactivate_context(trace_token)
            self._executing_tids.pop(tid, None)
            self._thread_task.pop(threading.get_ident(), None)
            self._mark_log_task(None)
            self._ctx.task_id = None
            self._ctx.task_name = ""

    def _store_returns(self, spec: TaskSpec, result: Any):
        num_returns = spec.num_returns
        if num_returns == 0:
            return []
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"task {spec.name} declared num_returns={num_returns} but "
                    f"returned {len(values)} values")
        out = []
        contained = {}
        for rid, value in zip(spec.return_ids(), values):
            oid = rid.binary()
            sobj = self.serialization.serialize(value)
            if self.serialization.last_contained_refs:
                # Refs nested in a return value: the return object's owner
                # is the CALLER, so report them in the reply — the caller
                # registers the object-keyed borrows with the inner owners
                # while our serialize-side pending pin still covers them.
                contained[oid] = [
                    (i, list(a) if a else None)
                    for i, a in self.serialization.last_contained_refs]
            if sobj.total_size <= GlobalConfig.max_direct_call_object_size:
                out.append((oid, "inline", sobj.to_bytes()))
            else:
                self._plasma_put(oid, sobj)
                out.append((oid, "plasma", self.node_id))
        return out, contained

    def _store_generator_returns(self, spec: TaskSpec, result: Any):
        """Execution side of num_returns="dynamic"/"streaming": store each
        yielded item as its own object; streaming additionally reports every
        item to the owner as it is produced (reference:
        `ReportGeneratorItemReturns`, `core_worker.proto:425`)."""
        streaming = spec.num_returns == -2
        owner = None
        if streaming and tuple(spec.owner_addr) != self.addr:
            owner = self._client_for(tuple(spec.owner_addr))
        items = []
        count = 0
        for value in result:
            oid = spec.generator_item_id(count).binary()
            sobj = self.serialization.serialize(value)
            # Refs nested in a yielded item ride along so the owner can
            # adopt object-keyed borrows (same contract as _store_returns).
            contained = [(i, list(a) if a else None)
                         for i, a in self.serialization.last_contained_refs]
            if sobj.total_size <= GlobalConfig.max_direct_call_object_size:
                entry = (oid, "inline", sobj.to_bytes(), contained)
            else:
                self._plasma_put(oid, sobj)
                entry = (oid, "plasma", self.node_id, contained)
            items.append(entry)
            if streaming:
                if owner is not None:
                    # Fire-and-forget, pipelined on the io loop: the
                    # producing thread never blocks a network round trip
                    # per item. A lost push self-heals — the final task
                    # reply re-delivers every item (owner-side dedup).
                    self.io.submit(owner.acall(
                        "report_generator_item",
                        task_id=spec.task_id.binary(), index=count,
                        item=entry, timeout=60))
                else:  # owner == executing worker (self-lease)
                    self._on_generator_item(spec.task_id.binary(), count,
                                            entry)
            count += 1
        return items, count

    # ---- generator plane (owner side) -------------------------------------
    def _on_generator_item(self, task_id: bytes, index: int, item) -> None:
        oid, kind, payload = item[0], item[1], item[2]
        contained = item[3] if len(item) > 3 else None
        entry = self._entry(oid)
        if not entry.event.is_set():
            if (not self.reference_counter.has_ref(oid)
                    and not self.reference_counter.is_freed(oid)):
                # First arrival only — re-produced items after a lineage
                # recovery are already tracked and must not inflate the
                # lineage live count.
                self.reference_counter.add_owned(oid)
                if task_id in self._lineage_live:
                    self._lineage_live[task_id] += 1
            if contained:
                # We own the item object: hold its nested refs until it
                # is freed (first arrival only — re-deliveries would
                # only duplicate the already-held borrows).
                self._adopt_contained(oid, contained)
            if kind == "inline":
                self._complete_object(oid, inline=payload)
            else:
                self.reference_counter.add_location(oid, payload)
                self._complete_object(oid, in_plasma=True)
        state = self._generators.get(task_id)
        if state is not None:
            with state.cond:
                state.produced = max(state.produced, index + 1)
                state.cond.notify_all()

    async def _h_report_generator_item(self, task_id, index, item):
        self._on_generator_item(task_id, index, item)
        return True

    def next_generator_ref(self, task_id: bytes, index: int) -> ObjectRef:
        """Blocks until item `index` of the generator task exists; raises
        StopIteration at the end (ObjectRefGenerator protocol)."""
        state = self._generators.get(task_id)
        if state is None:
            raise RuntimeError(
                f"no generator state for task {task_id.hex()} "
                "(ObjectRefGenerator is only usable in the owner process)")
        with state.cond:
            while True:
                if index < state.produced:
                    break
                if state.error is not None:
                    self._raise_task_error(state.error)
                if state.total is not None and index >= state.total:
                    raise StopIteration
                if not state.cond.wait(timeout=300):
                    raise exc.GetTimeoutError(
                        f"generator item {index} of {task_id.hex()} did not "
                        "arrive within 300s")
        ref_oid = ObjectID.for_task_return(TaskID(task_id),
                                           index + 2).binary()
        return ObjectRef(ref_oid, self.addr, self.worker_id.binary())

    def generator_progress(self, task_id: bytes):
        state = self._generators.get(task_id)
        if state is None:
            return 0, None
        with state.cond:
            return state.produced, state.total

    # ---- lineage / object recovery (owner side) ---------------------------
    def _drop_lineage(self, tid: bytes) -> None:
        self._lineage_live.pop(tid, None)
        spec = self._lineage.pop(tid, None)
        self._generators.pop(tid, None)
        if spec is not None:
            # Release the lineage-pinned arg deps (deferred _release_deps).
            for arg in spec.args:
                if arg.is_ref and tuple(arg.owner_addr) == self.addr:
                    self.reference_counter.remove_task_dependency(
                        arg.object_id)

    def _task_return_oids(self, spec: TaskSpec) -> List[bytes]:
        oids = [rid.binary() for rid in spec.return_ids()]
        if spec.num_returns < 0:
            state = self._generators.get(spec.task_id.binary())
            produced = state.produced if state is not None else 0
            oids += [spec.generator_item_id(i).binary()
                     for i in range(produced)]
        return oids

    def _try_recover_object(self, oid: bytes,
                            timeout: Optional[float] = None) -> bool:
        """Reconstruct a lost plasma object by re-executing its creating
        task (reference: `object_recovery_manager.h:90` RecoverObject +
        lineage in `task_manager.cc:896`). Waits at most `timeout` (caller's
        get() budget) for the re-execution to finish."""
        tid = bytes(oid[:TaskID.SIZE])
        spec = self._lineage.get(tid)
        if spec is None:
            return False
        with self._objects_lock:
            ev = self._recovering.get(tid)
            fresh = ev is None
            if fresh:
                ev = self._recovering[tid] = threading.Event()
        if fresh:
            for roid in self._task_return_oids(spec):
                with self._objects_lock:
                    self._objects[roid] = _PendingObject()
                for node in self.reference_counter.locations(roid):
                    self.reference_counter.remove_location(roid, node)
            state = self._generators.get(tid)
            if state is not None:
                with state.cond:
                    state.produced = 0
                    state.total = None
                    state.error = None
            fut = self.io.submit(self._run_normal_task(spec))

            def _done(_f):
                ev.set()
                self._recovering.pop(tid, None)

            fut.add_done_callback(_done)
        wait_s = 300.0 if timeout is None else min(timeout, 300.0)
        if not ev.wait(timeout=wait_s):
            return False
        return True

    async def _h_recover_object(self, object_id):
        ok = await asyncio.get_running_loop().run_in_executor(
            None, self._try_recover_object, object_id)
        return {"ok": ok}

    # ---- actor execution --------------------------------------------------
    async def _h_create_actor(self, spec: TaskSpec, gpu_ids=None):
        loop = asyncio.get_running_loop()

        def _construct():
            # Blocking work (KV fetch, arg gets, __init__) stays off the loop.
            from ray_tpu_torch.accelerators.gpu import note_lease

            note_lease(list(gpu_ids or []))
            self._actor_gpu_ids = list(gpu_ids or [])
            cls = self._load_function(spec.function.function_hash)
            args, kwargs = self._resolve_args(spec)
            return cls(*args, **kwargs)

        try:
            instance = await loop.run_in_executor(self._task_executor,
                                                  _construct)
            self._actor = _ActorState(instance, spec)
            return {"ok": True}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}",
                    "error_payload": serialize_error(e)}

    async def _h_push_actor_task(self, spec: TaskSpec, seq: int,
                                 caller_id: bytes):
        """Ordered execution per caller (reference: ActorSchedulingQueue with
        sequence numbers). Tasks start strictly in sequence order; with
        max_concurrency > 1 they may overlap after starting."""
        actor = self._actor
        if getattr(self, "_killed", False):
            return {"results": [], "app_error": serialize_error(
                exc.ActorDiedError("actor was killed via ray.kill"))}
        if actor is None:
            return {"results": [], "app_error": serialize_error(
                exc.ActorUnavailableError("actor is not initialized yet"))}
        loop = asyncio.get_running_loop()
        if seq < actor.expected_seq[caller_id]:
            # Retry of a task we may have already started (at-least-once
            # under max_task_retries): execute immediately, out of band.
            return await self._execute_actor_task(actor, spec)
        my_turn = loop.create_future()
        actor.pending[caller_id][seq] = my_turn
        self._advance_caller_queue(actor, caller_id)
        await my_turn
        # In-order START, concurrent execution: bump the expected sequence as
        # soon as this task begins so the next one can start while we run
        # (bounded by max_concurrency via the executor/semaphore).
        actor.expected_seq[caller_id] = seq + 1
        self._advance_caller_queue(actor, caller_id)
        return await self._execute_actor_task(actor, spec)

    def _advance_caller_queue(self, actor: _ActorState, caller_id: bytes):
        expected = actor.expected_seq[caller_id]
        fut = actor.pending[caller_id].pop(expected, None)
        if fut is not None and not fut.done():
            fut.set_result(None)

    async def _execute_actor_task(self, actor: _ActorState, spec: TaskSpec):
        loop = asyncio.get_running_loop()
        if spec.task_id.binary() in self._cancelled_tasks:
            return {"results": [], "app_error": serialize_error(
                exc.TaskCancelledError(f"task {spec.name} cancelled"))}
        method_name = spec.function.qualname
        from ray_tpu_torch.dag import COMPILED_STAGE_METHOD

        if method_name == COMPILED_STAGE_METHOD:
            # Compiled-DAG resident stage loop (ray_tpu_torch.dag):
            # occupies this actor's executor until the DAG is torn down.
            from ray_tpu_torch.dag import run_compiled_stage

            method = lambda payload: run_compiled_stage(  # noqa: E731
                actor.instance, payload)
        else:
            method = getattr(actor.instance, method_name, None)
        if method is None:
            return {"results": [], "app_error": serialize_error(
                AttributeError(f"actor has no method {method_name!r}"))}
        self._mark_log_task(spec, actor.spec.actor_id.hex())
        # Restore the caller's trace context for the method body. Each
        # push_actor_task dispatch runs as its own asyncio task, so the
        # contextvar keeps concurrent requests in one max_concurrency>1
        # actor on disjoint trace identities. Sync methods hop to a
        # pool thread (contextvars don't cross run_in_executor), so the
        # callable re-activates the wire context thread-side.
        from ray_tpu_torch.util import tracing as _tracing

        trace_token = _tracing.activate_wire_context(spec.trace_ctx)
        try:
            args, kwargs = await loop.run_in_executor(
                self._task_executor, self._resolve_args, spec)
            if actor.is_async and asyncio.iscoroutinefunction(method):
                async with actor.semaphore:
                    result = await method(*args, **kwargs)
            else:
                wire = spec.trace_ctx

                def _call_traced():
                    tok = _tracing.activate_wire_context(wire)
                    try:
                        return method(*args, **kwargs)
                    finally:
                        _tracing.deactivate_context(tok)

                result = await loop.run_in_executor(
                    actor.executor_for(spec.concurrency_group),
                    _call_traced)
            if spec.num_returns < 0:
                # Actor generator methods stream like normal-task ones:
                # each yielded item becomes an object, pushed to the owner
                # as produced (num_returns="streaming").
                results, count = await loop.run_in_executor(
                    self._task_executor, self._store_generator_returns,
                    spec, result)
                return {"results": results, "generator_count": count}
            results, contained = await loop.run_in_executor(
                self._task_executor, self._store_returns, spec, result)
            return {"results": results, "contained": contained}
        except Exception as e:  # noqa: BLE001
            return {"results": [], "app_error": serialize_error(e)}
        finally:
            _tracing.deactivate_context(trace_token)
            self._mark_log_task(None, end_tid=spec.task_id.hex())

    # ======================================================================
    # Runtime context / shutdown
    # ======================================================================
    def current_task_id(self) -> Optional[TaskID]:
        return self._ctx.task_id

    def current_gpu_ids(self) -> List[int]:
        if self._actor is not None:
            return list(getattr(self, "_actor_gpu_ids", []))
        return list(self._ctx.gpu_ids)

    def current_actor_id(self) -> Optional[bytes]:
        if self._actor is not None:
            return self._actor.spec.actor_id.binary()
        return None

    def async_get(self, refs):
        return asyncio.to_thread(self.get_objects, refs, None)

    def shutdown(self):
        # Deferred GC releases first, while the raylet connection is
        # still alive — pending view releases queued in the last drainer
        # interval would otherwise leave client read-pins until the
        # raylet's client-death sweep.
        try:
            self.drain_releases()
        except Exception:
            pass
        # Tell owners we no longer hold any borrowed refs (best effort —
        # their liveness sweep reaps us anyway if this is lost).
        for oid, addr in self.reference_counter.drain_borrows():
            try:
                self._client_for(tuple(addr)).call(
                    "release_borrower", object_id=oid,
                    key=self.worker_id.binary(), timeout=2)
            except Exception:
                pass
        # Final task-event + user-metric flush before the GCS connection
        # closes (synchronous: the io loop dies with us).
        try:
            with self._task_events_lock:
                batch, self._task_events = self._task_events, []
            if batch:
                self.gcs.call("push_task_events", events=batch, timeout=5)
        except Exception:
            pass
        try:
            from ray_tpu_torch.util import metrics as _metrics
            _metrics.flush()
        except Exception:
            pass
        if len(self._mapped):
            try:
                for mobj in list(self._mapped.values()):
                    mobj.mark_released()  # bulk release below covers them
                self.raylet.call("release_objects",
                                 object_ids=list(self._mapped.keys()),
                                 client_id=self.worker_id.binary(),
                                 timeout=5)
            except Exception:
                pass
        # Hand parked reusable leases back before the connections close so
        # their resources free immediately (not via job-cleanup timers).
        for st in list(self._lease_pool.values()):
            while st.idle:
                lease = st.idle.popleft()
                try:
                    lease["_lessor"].call(
                        "return_worker", worker_id=lease["worker_id"],
                        kill=False, lease_token=lease.get("lease_token"),
                        timeout=5)
                except Exception:
                    pass
        self._lease_pool.clear()
        self._dead = True
        # Drop the whole ref graph now: a long-lived driver accumulates
        # millions of counter entries and GC over them after the worker
        # object dies dominates interpreter time.
        try:
            self.reference_counter.clear()
        except Exception:
            pass
        for b in self._actor_batchers.values():
            if b.task is not None:
                try:
                    self.io.loop.call_soon_threadsafe(b.task.cancel)
                except Exception:
                    pass
        self._actor_batchers.clear()
        try:
            self.server.stop()
        except Exception:
            pass
        for client in ([self.gcs, self.raylet]
                       + list(self._worker_clients.values())
                       + list(self._raylet_clients.values())):
            try:
                client.close()
            except Exception:
                pass
        for mobj in self._mapped.values():
            mobj.close()
        self._mapped.clear()
        set_global_worker(None)


# ---------------------------------------------------------------------------
# Option helpers
# ---------------------------------------------------------------------------

def _resources_from_options(options: Dict[str, Any]) -> ResourceSet:
    res = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    num_gpus = options.get("num_gpus")
    if num_gpus is not None:
        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

        ok, msg = GPUAcceleratorManager.validate_resource_request_quantity(
            num_gpus)
        if not ok:
            raise ValueError(msg)
        res[GPU] = num_gpus
    accelerator_type = options.get("accelerator_type")
    if accelerator_type:
        res[f"GPU-{accelerator_type}"] = 0.001
    res["CPU"] = 1 if num_cpus is None else num_cpus
    if options.get("memory"):
        res["memory"] = options["memory"]
    return ResourceSet(res)


def _strategy_from_options(options: Dict[str, Any]) -> SchedulingStrategySpec:
    strategy = options.get("scheduling_strategy")
    if strategy is None or strategy == "DEFAULT":
        return SchedulingStrategySpec()
    if strategy == "SPREAD":
        return SchedulingStrategySpec(kind="SPREAD")
    # Strategy objects from ray_tpu_torch.util.scheduling_strategies
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return SchedulingStrategySpec(
            kind="PLACEMENT_GROUP",
            placement_group_id=strategy.placement_group.id,
            bundle_index=strategy.placement_group_bundle_index,
            capture_child_tasks=strategy.placement_group_capture_child_tasks)
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return SchedulingStrategySpec(kind="NODE_AFFINITY",
                                      node_id=strategy.node_id,
                                      soft=strategy.soft)
    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return SchedulingStrategySpec(kind="NODE_LABEL",
                                      hard_labels=strategy.hard or {},
                                      soft_labels=strategy.soft or {})
    raise ValueError(f"unknown scheduling strategy: {strategy!r}")
