"""gRPC ingress — deployed applications over gRPC, same routing plane as
the HTTP proxy: the port's copy of ``ray_tpu/serve/_private/grpc_proxy.py``.

Reference: the gRPC proxy in `serve/_private/proxy.py` +
`serve/_private/grpc_util.py` (gRPCGenericServer). Re-designed without
compiled protos: a generic bytes-in/bytes-out service

    /ray_tpu_torch.serve.ServeAPI/Predict        (unary-unary)
    /ray_tpu_torch.serve.ServeAPI/PredictStream  (unary-stream)

where the target application, method and multiplexed model id travel in
invocation metadata (``application``, ``method``,
``multiplexed_model_id``) — exactly how the reference's gRPC ingress
selects apps. Payload bytes that parse as JSON become Python values;
replies that are bytes pass through raw, strings utf-8, anything else
JSON. Routing state (long-polled route table, per-app handles) mirrors
the HTTP proxy. The service is named after the port's package (the
JAX package's is ``ray_tpu.serve.ServeAPI``; ``grpc_util`` speaks the
port's); ``grpc`` is imported only inside the proxy's server thread and
the functions that need it.

User-DEFINED protobuf servicers are supported via
``grpc_servicer_functions`` (reference: `grpc_options.grpc_servicer_
functions` + `grpc_util.gRPCGenericServer`): each generated
``add_XServicer_to_server`` function is invoked against a capture shim
that harvests every RPC's full method path, kind, and request/response
(de)serializers; the proxy then serves those exact paths, handing the
DESERIALIZED request message to the deployment method named after the
rpc and serializing its returned message back — schema'd stubs work
unchanged against the proxy.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch.serve._private.route_plane import RoutePlane

SERVICE = "ray_tpu_torch.serve.ServeAPI"
PREDICT = f"/{SERVICE}/Predict"
PREDICT_STREAM = f"/{SERVICE}/PredictStream"


def _encode(value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    return json.dumps(value).encode()


def _decode(raw: bytes) -> Any:
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return raw


class _DummyServicer:
    """Stand-in passed to generated add_*_to_server functions during
    harvesting; generated code only getattr()s rpc method names."""

    def __getattr__(self, name):
        return lambda *a, **k: None


class _HarvestServer:
    """Capture shim with the grpc.Server registration surface. Generated
    code either wraps its handler dict in a generic handler
    (add_generic_rpc_handlers) or, in newer grpcio, registers the dict
    directly (add_registered_method_handlers); both are captured."""

    def __init__(self):
        self.methods: Dict[str, Any] = {}   # "/pkg.Svc/Rpc" -> handler

    def add_generic_rpc_handlers(self, handlers):
        for h in handlers:
            per_method = getattr(h, "_method_handlers", None)
            if per_method:
                self.methods.update(per_method)

    def add_registered_method_handlers(self, service, handlers):
        for name, h in handlers.items():
            self.methods[f"/{service}/{name}"] = h


def harvest_servicer_methods(servicer_functions) -> Dict[str, Any]:
    """Run each add_XServicer_to_server against the capture shim; returns
    {method_path: grpc RpcMethodHandler} carrying each rpc's kind and
    request_deserializer / response_serializer."""
    import importlib

    out: Dict[str, Any] = {}
    for fn in servicer_functions or []:
        if isinstance(fn, str):
            module, _, attr = fn.rpartition(".")
            fn = getattr(importlib.import_module(module), attr)
        shim = _HarvestServer()
        fn(_DummyServicer(), shim)
        for path, h in shim.methods.items():
            if getattr(h, "request_streaming", False):
                # Client-streaming kinds would need request iterator
                # plumbing across the handle; serving them with a unary
                # handler mis-frames the call — reject loudly instead.
                raise ValueError(
                    f"grpc_servicer_functions: rpc '{path}' is "
                    "client-streaming (stream_unary/stream_stream), "
                    "which the proxy does not support; only unary_unary "
                    "and unary_stream rpcs can be routed")
            out[path] = h
    return out


@ray_tpu_torch.remote(num_cpus=0.5, max_concurrency=16)
class GrpcProxyActor(RoutePlane):
    """Per-cluster gRPC ingress actor (HeadOnly placement by default).
    Routing state comes from the shared RoutePlane mixin — one route
    table implementation for both ingress flavors."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 servicer_functions=None):
        from ray_tpu_torch.serve._private.controller import get_or_create_controller

        self.port = None
        self._user_methods = harvest_servicer_methods(servicer_functions)
        self._pre_init_route_plane()
        started = threading.Event()
        self._loop_thread = threading.Thread(
            target=self._serve_forever, args=(host, port, started),
            daemon=True, name="serve-grpc-proxy")
        self._loop_thread.start()
        started.wait(timeout=30)
        self._init_route_plane(get_or_create_controller())

    # ---- grpc server ------------------------------------------------------
    def _serve_forever(self, host: str, port: int,
                       started: threading.Event):
        import grpc
        import grpc.aio

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        outer = self

        def _meta(context) -> Dict[str, str]:
            return {k: v for k, v in (context.invocation_metadata() or ())}

        async def _handle_or_abort(app: str, context):
            # The route table is push-invalidated; tolerate only the
            # short deploy-to-first-poll race (bounded), then NOT_FOUND.
            for _ in range(15):
                try:
                    return outer._handle_for(app)
                except KeyError:
                    await asyncio.sleep(0.1)
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no application '{app}'")

        async def predict(request: bytes, context) -> bytes:
            md = _meta(context)
            app = md.get("application", "default")
            method = md.get("method", "__call__")
            handle = await _handle_or_abort(app, context)
            if md.get("multiplexed_model_id"):
                handle = handle.options(
                    multiplexed_model_id=md["multiplexed_model_id"])
            payload = _decode(request)
            args = (payload,) if payload is not None else ()
            caller = getattr(handle, method) if method != "__call__" \
                else handle
            try:
                reply = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: caller.remote(*args).result(timeout=120))
            except Exception as e:  # noqa: BLE001 — surfaced as grpc error
                await context.abort(grpc.StatusCode.INTERNAL,
                                    f"{type(e).__name__}: {e}")
            return _encode(reply)

        async def predict_stream(request: bytes, context):
            md = _meta(context)
            app = md.get("application", "default")
            method = md.get("method", "__call__")
            handle = await _handle_or_abort(app, context)
            if md.get("multiplexed_model_id"):
                handle = handle.options(
                    multiplexed_model_id=md["multiplexed_model_id"])
            payload = _decode(request)
            args = (payload,) if payload is not None else ()
            shandle = handle.options(stream=True)
            caller = getattr(shandle, method) if method != "__call__" \
                else shandle
            loop = asyncio.get_running_loop()
            gen = await loop.run_in_executor(
                None, lambda: caller.remote(*args))
            it = iter(gen)
            _stop = object()

            def _next():
                try:
                    return next(it)
                except StopIteration:
                    return _stop

            while True:
                item = await loop.run_in_executor(None, _next)
                if item is _stop:
                    break
                yield _encode(item)

        def _user_method(path: str, spec):
            """Route a harvested user-proto rpc: app from metadata,
            deployment method named after the rpc, request handed over
            as the DESERIALIZED message."""
            rpc_name = path.rsplit("/", 1)[-1]

            async def unary(request, context):
                md = _meta(context)
                app = md.get("application", "default")
                handle = await _handle_or_abort(app, context)
                if md.get("multiplexed_model_id"):
                    handle = handle.options(
                        multiplexed_model_id=md["multiplexed_model_id"])
                caller = getattr(handle, rpc_name)
                try:
                    return await asyncio.get_running_loop().run_in_executor(
                        None,
                        lambda: caller.remote(request).result(timeout=120))
                except Exception as e:  # noqa: BLE001
                    await context.abort(grpc.StatusCode.INTERNAL,
                                        f"{type(e).__name__}: {e}")

            async def stream(request, context):
                md = _meta(context)
                app = md.get("application", "default")
                handle = await _handle_or_abort(app, context)
                if md.get("multiplexed_model_id"):
                    handle = handle.options(
                        multiplexed_model_id=md["multiplexed_model_id"])
                caller = getattr(handle.options(stream=True), rpc_name)
                loop = asyncio.get_running_loop()
                gen = await loop.run_in_executor(
                    None, lambda: caller.remote(request))
                it = iter(gen)
                _stop = object()

                def _next():
                    try:
                        return next(it)
                    except StopIteration:
                        return _stop

                while True:
                    item = await loop.run_in_executor(None, _next)
                    if item is _stop:
                        break
                    yield item

            if getattr(spec, "unary_stream", None) is not None:
                return grpc.unary_stream_rpc_method_handler(
                    stream,
                    request_deserializer=spec.request_deserializer,
                    response_serializer=spec.response_serializer)
            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=spec.request_deserializer,
                response_serializer=spec.response_serializer)

        class Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                if call_details.method == PREDICT:
                    return grpc.unary_unary_rpc_method_handler(predict)
                if call_details.method == PREDICT_STREAM:
                    return grpc.unary_stream_rpc_method_handler(
                        predict_stream)
                spec = outer._user_methods.get(call_details.method)
                if spec is not None:
                    return _user_method(call_details.method, spec)
                return None

        async def _main():
            server = grpc.aio.server()
            server.add_generic_rpc_handlers((Handler(),))
            bound = server.add_insecure_port(f"{host}:{port}")
            await server.start()
            self.port = bound
            started.set()
            await server.wait_for_termination()

        loop.run_until_complete(_main())

    # ---- actor api --------------------------------------------------------
    def get_user_method_paths(self):
        """The harvested user-proto rpc paths this proxy serves (lets
        serve.start_grpc detect a live proxy that lacks newly requested
        servicers and recreate it)."""
        return sorted(self._user_methods)

    def get_port(self) -> int:
        # The server thread publishes the port asynchronously; never hand
        # out None to a client that called right after creation.
        import time as _time

        deadline = _time.monotonic() + 20
        while self.port is None and _time.monotonic() < deadline:
            _time.sleep(0.05)
        return self.port

    def healthz(self) -> bool:
        return True
