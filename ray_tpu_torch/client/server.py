"""Client proxy server — a server-side driver mirror.

Reference: `python/ray/util/client/server/server.py` — every public API
call a thin client makes is replayed here against the real cluster; the
server pins the resulting ObjectRefs/ActorHandles per client session so
cluster-side GC follows the CLIENT's lifetime, not wire round-trips.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, List

from ray_tpu_torch.client.common import active_server, dumps as client_dumps
from ray_tpu_torch._private.rpc import RpcServer


class ClientServer:
    """Serves thin clients using THIS process's driver connection."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._server = RpcServer(host, port)
        # Session pins: object refs / actor handles the client still uses.
        self._refs: Dict[bytes, Any] = {}
        self._actors: Dict[bytes, Any] = {}
        for name in ["export_function", "submit_task", "get", "put",
                     "wait", "release", "create_actor",
                     "submit_actor_task", "get_actor", "kill_actor",
                     "release_actor", "cancel", "gcs_call", "ping",
                     "disconnect",
                     # msgpack-typed surface for non-Python frontends
                     # (the C++ client in cpp/): see cross_language.py.
                     "xlang_call", "xlang_get", "xlang_put",
                     "xlang_wait", "xlang_create_actor",
                     "xlang_actor_call", "xlang_get_actor"]:
            self._server.register(f"client_{name}",
                                  getattr(self, f"_h_{name}"))
        self._xlang_fns: Dict[str, Any] = {}
        self._xlang_actor_cls: Dict[str, Any] = {}

    def start(self) -> int:
        return self._server.start()

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._server.stop()
        self._refs.clear()
        self._actors.clear()

    # -------------------------------------------------------------- helpers
    def _pin(self, ref) -> bytes:
        self._refs[ref.binary()] = ref
        return ref.binary()

    def _ref(self, object_id: bytes):
        ref = self._refs.get(object_id)
        if ref is None:
            raise KeyError(f"unknown/released object {object_id.hex()[:12]}")
        return ref

    def _resolve_args(self, payload: bytes):
        # Markers anywhere in the graph rebuild into the real pinned
        # refs/handles while this server is "active".
        with active_server(self):
            args, kwargs = pickle.loads(payload)
        return list(args), kwargs

    def _actor_handle(self, actor_id: bytes, class_name: str = "Actor"):
        handle = self._actors.get(actor_id)
        if handle is None:
            from ray_tpu_torch.actor import ActorHandle

            handle = ActorHandle(actor_id, class_name)
            self._actors[actor_id] = handle
        return handle

    # ------------------------------------------------------------- handlers
    @staticmethod
    async def _blocking(fn, *args):
        """Worker calls do sync RPC internally (export -> kv_put, submit
        -> lease); they must run OFF the server's io loop."""
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    async def _h_ping(self):
        return True

    async def _h_export_function(self, payload):
        from ray_tpu_torch._private.worker import global_worker

        return await self._blocking(global_worker().export_function,
                                    payload)

    async def _h_submit_task(self, fn_hash, fn_name, args_payload, options):
        from ray_tpu_torch._private.worker import global_worker

        args, kwargs = self._resolve_args(args_payload)
        if isinstance(options.get("num_returns"), str):
            raise NotImplementedError(
                "dynamic/streaming returns are not supported in client "
                "mode yet")
        refs = await self._blocking(
            lambda: global_worker().submit_task(fn_hash, fn_name, args,
                                                kwargs, options))
        return [self._pin(r) for r in refs]

    async def _h_get(self, object_ids, wait_timeout):
        import asyncio

        from ray_tpu_torch._private.worker import global_worker

        refs = [self._ref(oid) for oid in object_ids]
        w = global_worker()
        values = await asyncio.get_running_loop().run_in_executor(
            None, lambda: w.get_objects(refs, wait_timeout))
        # Refs nested in results are pinned before shipping so the client
        # can get() them later.
        return client_dumps(values, pin=self._pin)

    async def _h_put(self, payload):
        from ray_tpu_torch._private.worker import global_worker

        value = pickle.loads(payload)
        ref = await self._blocking(global_worker().put, value)
        return self._pin(ref)

    # --------------------------------------------------- xlang (msgpack)
    def _xlang_remote(self, func: str):
        """Cache one RemoteFunction per cross-language symbol so repeated
        calls reuse the exported function hash."""
        rf = self._xlang_fns.get(func)
        if rf is None:
            import ray_tpu_torch
            from ray_tpu_torch.cross_language import resolve

            rf = ray_tpu_torch.remote(resolve(func))
            self._xlang_fns[func] = rf
        return rf

    async def _h_xlang_call(self, func, args, options=None):
        """Submit `func` (registered name or "module:attr") with
        msgpack-typed args; returns the result ref id (bytes)."""
        from ray_tpu_torch.cross_language import decode

        rf = self._xlang_remote(func)
        if options:
            rf = rf.options(**options)
        call_args = [decode(a) for a in (args or [])]
        ref = await self._blocking(lambda: rf.remote(*call_args))
        return self._pin(ref)

    async def _h_xlang_get(self, object_id, wait_timeout=None):
        import asyncio

        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.cross_language import encode

        ref = self._ref(object_id)
        w = global_worker()
        (value,) = await asyncio.get_running_loop().run_in_executor(
            None, lambda: w.get_objects([ref], wait_timeout))
        return encode(value)

    async def _h_xlang_put(self, value):
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.cross_language import decode

        ref = await self._blocking(global_worker().put, decode(value))
        return self._pin(ref)

    async def _h_xlang_wait(self, object_ids, num_returns, wait_timeout):
        import asyncio

        import ray_tpu_torch

        refs = [self._ref(oid) for oid in object_ids]
        ready, pending = await asyncio.get_running_loop().run_in_executor(
            None, lambda: ray_tpu_torch.wait(refs, num_returns=num_returns,
                                       timeout=wait_timeout))
        return [[r.binary() for r in ready],
                [r.binary() for r in pending]]

    async def _h_xlang_create_actor(self, cls, args, options=None):
        """Create an actor from a cross-language symbol (a name
        registered via cross_language.register — e.g. a cpp_actor_class
        — or an importable "module:Class"); msgpack-typed args. Returns
        the actor id (bytes); kill/release ride the existing
        client_kill_actor / client_release_actor methods, whose
        payloads are already msgpack-representable."""
        import ray_tpu_torch
        from ray_tpu_torch.cross_language import decode, resolve

        acls = self._xlang_actor_cls.get(cls)
        if acls is None:
            acls = ray_tpu_torch.remote(resolve(cls))
            self._xlang_actor_cls[cls] = acls
        if options:
            acls = acls.options(**options)
        call_args = [decode(a) for a in (args or [])]
        handle = await self._blocking(lambda: acls.remote(*call_args))
        self._actors[handle._actor_id] = handle
        return handle._actor_id

    async def _h_xlang_actor_call(self, actor_id, method, args):
        """Invoke a method on a pinned actor with msgpack-typed args;
        returns the result ref id (fetch via client_xlang_get)."""
        from ray_tpu_torch.cross_language import decode

        handle = self._actors.get(actor_id)
        if handle is None:
            raise KeyError(
                f"unknown or released actor {actor_id!r}; create it via "
                f"xlang_create_actor or look it up via xlang_get_actor")
        call_args = [decode(a) for a in (args or [])]
        refs = await self._blocking(
            lambda: getattr(handle, method).remote(*call_args))
        ref = refs if not isinstance(refs, (list, tuple)) else refs[0]
        return self._pin(ref)

    async def _h_xlang_get_actor(self, name, namespace=None):
        from ray_tpu_torch._private.worker import global_worker

        # Named actors register under "default" when no namespace is
        # given; passing None through would miss every one of them.
        handle = await self._blocking(global_worker().get_actor, name,
                                      namespace or "default")
        self._actors[handle._actor_id] = handle
        return handle._actor_id

    async def _h_wait(self, object_ids, num_returns, wait_timeout,
                      fetch_local):
        import asyncio

        from ray_tpu_torch._private.worker import global_worker

        refs = [self._ref(oid) for oid in object_ids]
        w = global_worker()
        ready, rest = await asyncio.get_running_loop().run_in_executor(
            None,
            lambda: w.wait(refs, num_returns, wait_timeout, fetch_local))
        return ([r.binary() for r in ready], [r.binary() for r in rest])

    async def _h_release(self, object_ids):
        for oid in object_ids:
            self._refs.pop(oid, None)
        return True

    async def _h_create_actor(self, cls_payload, cls_name, args_payload,
                              options):
        from ray_tpu_torch._private.worker import global_worker

        args, kwargs = self._resolve_args(args_payload)
        handle = await self._blocking(
            lambda: global_worker().create_actor(cls_payload, cls_name,
                                                 args, kwargs, options))
        self._actors[handle._actor_id] = handle
        return {"actor_id": handle._actor_id,
                "class_name": handle._class_name}

    async def _h_submit_actor_task(self, actor_id, method_name,
                                   args_payload, options,
                                   max_task_retries):
        from ray_tpu_torch._private.worker import global_worker

        args, kwargs = self._resolve_args(args_payload)
        refs = await self._blocking(
            lambda: global_worker().submit_actor_task(
                actor_id, method_name, args, kwargs, options,
                max_task_retries=max_task_retries))
        return [self._pin(r) for r in refs]

    async def _h_get_actor(self, name, namespace):
        from ray_tpu_torch._private.worker import global_worker

        handle = await self._blocking(global_worker().get_actor, name,
                                      namespace)
        self._actors[handle._actor_id] = handle
        return {"actor_id": handle._actor_id,
                "class_name": handle._class_name}

    async def _h_kill_actor(self, actor_id, no_restart):
        from ray_tpu_torch._private.worker import global_worker

        await self._blocking(global_worker().kill_actor, actor_id,
                             no_restart)
        return True

    async def _h_release_actor(self, actor_id):
        self._actors.pop(actor_id, None)
        return True

    async def _h_cancel(self, object_id, force):
        from ray_tpu_torch._private.worker import global_worker

        await self._blocking(global_worker().cancel_task,
                             self._ref(object_id), force)
        return True

    async def _h_disconnect(self):
        """Client session end: drop every pin so cluster-side GC can run
        (a crashed client that never calls this leaks its pins — the
        single-session proxy has no liveness tracking yet)."""
        self._refs.clear()
        self._actors.clear()
        return True

    async def _h_gcs_call(self, gcs_method, kwargs):
        from ray_tpu_torch._private.worker import global_worker

        return await global_worker().gcs.acall(gcs_method, timeout=30,
                                               **kwargs)


def serve(port: int = 0, host: str = "0.0.0.0") -> ClientServer:
    """Start a client proxy inside the current driver; returns it."""
    server = ClientServer(host, port)
    server.start()
    return server


def main() -> None:
    import signal
    import sys

    import ray_tpu_torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True,
                        help="GCS address host:port of the cluster to join")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=10001)
    args = parser.parse_args()

    ray_tpu_torch.init(address=args.address, log_to_driver=False)
    server = serve(args.port, args.host)
    print(f"CLIENT_SERVER_PORT={server.port}", flush=True)
    sys.stdout.flush()
    signal.pause()


if __name__ == "__main__":
    main()
