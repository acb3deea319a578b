"""ClientWorker — the thin-client stand-in for the in-process Worker.

Reference: `python/ray/util/client/worker.py` — implements the worker
surface the public API calls (`submit_task`, `get_objects`, `put`,
actors, `wait`, `kill`/`cancel`) by forwarding each to the proxy server,
so `ray_tpu_torch.init(address="ray_tpu_torch://host:port")` makes the ordinary API
work unchanged from outside the cluster.
"""

from __future__ import annotations

import collections
import pickle
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.client.common import dumps as client_dumps
from ray_tpu_torch._private.ids import WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.rpc import RpcClient


class _ClientRefCounter:
    """Local refcounts; zero -> release the server-side pin."""

    def __init__(self, owner: "ClientWorker"):
        self._owner = owner
        self._counts: Dict[bytes, int] = {}
        self._lock = threading.Lock()

    def add_local_ref(self, object_id: bytes) -> None:
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + 1

    def remove_local_ref(self, object_id: bytes) -> None:
        if self._decref(object_id):
            self._owner._release_objects([object_id])

    def _decref(self, object_id: bytes) -> bool:
        """Drop one local ref; True iff the count reached zero (the
        caller then releases the server-side pin)."""
        with self._lock:
            n = self._counts.get(object_id, 0) - 1
            if n > 0:
                self._counts[object_id] = n
                return False
            self._counts.pop(object_id, None)
            return True

    def mark_shared(self, object_id: bytes) -> None:
        # Shared into a task argument: keep the server pin for the
        # session (conservative, mirrors the in-process counter).
        with self._lock:
            self._counts[object_id] = self._counts.get(object_id, 0) + 1


class _ClientActorGC:
    def __init__(self, owner: "ClientWorker"):
        self._owner = owner
        self._counts: Dict[bytes, int] = {}
        self._lock = threading.Lock()

    def add_ref(self, actor_id: bytes) -> None:
        with self._lock:
            self._counts[actor_id] = self._counts.get(actor_id, 0) + 1

    def remove_ref(self, actor_id: bytes) -> None:
        # GC-context entry (ActorHandle.__del__): append-only, like the
        # in-process worker — never RPC under a finalizer.
        self._owner.defer_actor_release(actor_id)

    def mark_created(self, actor_id: bytes) -> None:
        pass

    def mark_shared(self, actor_id: bytes) -> None:
        self.add_ref(actor_id)

    def _decref(self, actor_id: bytes) -> bool:
        with self._lock:
            n = self._counts.get(actor_id, 0) - 1
            if n > 0:
                self._counts[actor_id] = n
                return False
            self._counts.pop(actor_id, None)
            return True


class ClientWorker:
    """Quacks like ray_tpu_torch._private.worker.Worker for the public API."""

    def __init__(self, host: str, port: int):
        self._client = RpcClient(host, port)
        self._client.call("client_ping", timeout=15)
        self.worker_id = WorkerID.from_random()
        self.namespace = "client"
        self.reference_counter = _ClientRefCounter(self)
        self.actor_handles = _ClientActorGC(self)
        self.gcs = _GcsProxy(self._client)
        self._closed = False
        # Deferred finalizer releases (ObjectRef/ActorHandle.__del__): a
        # __del__ must never RPC — append here, drain from the background
        # thread and at shutdown; without it every server-side pin would
        # stay for the whole session.
        self._pending_releases: collections.deque = collections.deque()
        self._pending_actor_releases: collections.deque = collections.deque()
        self._release_wake = threading.Event()
        self._release_thread = threading.Thread(
            target=self._release_loop, name="client-release-drainer",
            daemon=True)
        self._release_thread.start()

    # ------------------------------------------------------------ marshall
    @staticmethod
    def _pack_args(args: Sequence[Any], kwargs: Dict[str, Any]) -> bytes:
        # ClientPickler reduces refs/handles anywhere in the graph.
        return client_dumps((list(args), dict(kwargs)))

    def _make_ref(self, object_id: bytes) -> ObjectRef:
        return ObjectRef(object_id, None, b"client")

    # ------------------------------------------------------------ task API
    def export_function(self, payload: bytes) -> str:
        return self._client.call("client_export_function", payload=payload,
                                 timeout=60)

    def submit_task(self, fn_hash: str, fn_name: str, args, kwargs,
                    options: Dict[str, Any]) -> List[ObjectRef]:
        if isinstance(options.get("num_returns"), str):
            raise NotImplementedError(
                "dynamic/streaming returns are not supported in client "
                "mode yet")
        ids = self._client.call(
            "client_submit_task", fn_hash=fn_hash, fn_name=fn_name,
            args_payload=self._pack_args(args, kwargs), options=options,
            timeout=120)
        return [self._make_ref(i) for i in ids]

    def put(self, value: Any) -> ObjectRef:
        oid = self._client.call("client_put",
                                payload=client_dumps(value),
                                timeout=120)
        return self._make_ref(oid)

    def get_objects(self, refs: Sequence[ObjectRef],
                    timeout: Optional[float]) -> List[Any]:
        payload = self._client.call(
            "client_get", object_ids=[r.binary() for r in refs],
            timeout=(timeout + 30) if timeout else None,
            **{"wait_timeout": timeout})
        return pickle.loads(payload)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        by_id = {r.binary(): r for r in refs}
        ready, rest = self._client.call(
            "client_wait", object_ids=list(by_id),
            num_returns=num_returns, fetch_local=fetch_local,
            timeout=(timeout + 30) if timeout else None,
            **{"wait_timeout": timeout})
        return [by_id[i] for i in ready], [by_id[i] for i in rest]

    # ----------------------------------------------------------- actor API
    def create_actor(self, cls_payload: bytes, cls_name: str, args, kwargs,
                     options: Dict[str, Any]):
        from ray_tpu_torch.actor import ActorHandle

        info = self._client.call(
            "client_create_actor", cls_payload=cls_payload,
            cls_name=cls_name,
            args_payload=self._pack_args(args, kwargs), options=options,
            timeout=180)
        return ActorHandle(info["actor_id"], info["class_name"],
                           max_task_retries=options.get(
                               "max_task_retries", 0))

    def submit_actor_task(self, actor_id: bytes, method_name: str, args,
                          kwargs, options: Dict[str, Any],
                          max_task_retries: int = 0) -> List[ObjectRef]:
        ids = self._client.call(
            "client_submit_actor_task", actor_id=actor_id,
            method_name=method_name,
            args_payload=self._pack_args(args, kwargs), options=options,
            max_task_retries=max_task_retries, timeout=120)
        return [self._make_ref(i) for i in ids]

    def get_actor(self, name: str, namespace: str = "default"):
        from ray_tpu_torch.actor import ActorHandle

        info = self._client.call("client_get_actor", name=name,
                                 namespace=namespace, timeout=60)
        return ActorHandle(info["actor_id"], info["class_name"])

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        self._client.call("client_kill_actor", actor_id=actor_id,
                          no_restart=no_restart, timeout=60)

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        self._client.call("client_cancel", object_id=ref.binary(),
                          force=force, timeout=60)

    # ------------------------------------------------------------- lifecycle
    def defer_release(self, oid: bytes) -> None:
        """GC-safe local-ref release (ObjectRef.__del__ only): lock-free
        append; the decref + server release run at the next drain."""
        self._pending_releases.append(oid)
        self._release_wake.set()

    def defer_actor_release(self, actor_id: bytes) -> None:
        self._pending_actor_releases.append(actor_id)
        self._release_wake.set()

    def drain_releases(self) -> None:
        """Apply deferred __del__ releases; batch zero-count objects into
        one server round-trip."""
        q = self._pending_releases
        dead: List[bytes] = []
        while q:
            try:
                oid = q.popleft()
            except IndexError:
                break
            try:
                if self.reference_counter._decref(oid):
                    dead.append(oid)
            except Exception:
                pass
        if dead:
            self._release_objects(dead)
        aq = self._pending_actor_releases
        while aq:
            try:
                actor_id = aq.popleft()
            except IndexError:
                break
            try:
                if self.actor_handles._decref(actor_id):
                    self._release_actor(actor_id)
            except Exception:
                pass

    def _release_loop(self) -> None:
        while not self._closed:
            self._release_wake.wait(timeout=1.0)
            self._release_wake.clear()
            if self._closed:
                return
            try:
                self.drain_releases()
            except Exception:
                pass

    def _release_objects(self, object_ids: List[bytes]) -> None:
        if self._closed:
            return
        try:
            self._client.call("client_release", object_ids=object_ids,
                              timeout=10)
        except Exception:
            pass

    def _release_actor(self, actor_id: bytes) -> None:
        if self._closed:
            return
        try:
            self._client.call("client_release_actor", actor_id=actor_id,
                              timeout=10)
        except Exception:
            pass

    def async_get(self, refs):
        import asyncio

        return asyncio.to_thread(self.get_objects, refs, None)

    def shutdown(self) -> None:
        try:
            self.drain_releases()
        except Exception:
            pass
        try:
            self._client.call("client_disconnect", timeout=10)
        except Exception:
            pass
        self._closed = True
        self._release_wake.set()
        try:
            self._client.close()
        except Exception:
            pass


class _GcsProxy:
    """`worker.gcs.call(...)` passthrough for the state/inspection APIs
    (nodes(), cluster_resources, ...)."""

    def __init__(self, client: RpcClient):
        self._client = client

    def call(self, method: str, timeout: Optional[float] = None, **kwargs):
        return self._client.call("client_gcs_call", gcs_method=method,
                                 kwargs=kwargs, timeout=timeout or 30)
