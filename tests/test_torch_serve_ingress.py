"""The port's Serve ingress (``ray_tpu_torch.serve``: the HTTP proxy on
the standard library's ``asyncio`` streams, the route plane, the gRPC
proxy, ``@serve.ingress``, ``@serve.batch`` and config deploys) on the
CPU.

The ingress cases of the reference's own ``tests/test_serve.py`` and
``tests/test_serve_features.py``, each asserting what it asserts there,
run against the port's cluster. The JAX package's jax-free ingress
functions (``asgi``'s path and query decoding, ``batching``'s batch
formation, ``schema``'s validation) run beside the port's on the same
inputs. The proxy's wire contract is held one rule per case, and an LLM
app served over HTTP gives the JAX package's greedy tokens. One cluster
for the module; every ``get`` and every HTTP call has a timeout.
"""

import ast
import dataclasses
import http.client
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def serve_cluster():
    info = ray_tpu_torch.init(
        num_cpus=8, num_gpus=0, object_store_memory=256 * 1024 * 1024,
        _system_config={"metrics_report_interval_s": 0.5,
                        "trace_sample_rate": 1.0})
    yield info
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def port(serve_cluster):
    """The HTTP proxy's port (one HeadOnly proxy for the module)."""
    proxy = serve.start()
    return ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)


def _url(port, path):
    return f"http://127.0.0.1:{port}{path}"


def _post(port, path, body, headers=None, timeout=60):
    req = urllib.request.Request(_url(port, path), data=body,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def _routed(app):
    """Wait until the HTTP proxy's route table holds ``app``'s current
    ingress. The table is pushed by the controller's long poll, so a
    request sent the moment ``serve.run`` returns can race the push (an
    app not yet in the table is a 404, as in the reference)."""
    from ray_tpu_torch.serve._private.controller import (
        get_or_create_controller,
    )

    ingress = ray_tpu_torch.get(
        get_or_create_controller().get_ingress.remote(app), timeout=30)
    proxy = ray_tpu_torch.get_actor("SERVE_PROXY")
    deadline = time.monotonic() + 30
    while True:
        routes = ray_tpu_torch.get(proxy.stats.remote(), timeout=30)["routes"]
        if routes.get(app, {}).get("deployment") == ingress:
            return
        assert time.monotonic() < deadline, (app, ingress, routes)
        time.sleep(0.05)


def _raw(port, data: bytes, timeout=30) -> bytes:
    """Send raw bytes on a fresh connection; everything until the server
    closes it."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(data)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk


# ------------------------------------ the reference's tests/test_serve.py


def test_http_proxy(serve_cluster):
    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return {"echoed": payload}

    serve.run(Echo.bind(), name="echo")
    proxy = serve.start()
    port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/echo",
        data=json.dumps({"msg": "hi"}).encode(),
        headers={"Content-Type": "application/json"})
    body = json.loads(urllib.request.urlopen(req, timeout=60).read())
    assert body["result"] == {"echoed": {"msg": "hi"}}

    # Unknown app -> 404
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/nosuchapp", timeout=30)
        pytest.fail("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    serve.delete("echo")


# ----------------------------- the reference's tests/test_serve_features.py


def test_batch_decorator_units():
    from ray_tpu_torch.serve import batch

    seen_batches = []

    @batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    def double(items):
        seen_batches.append(len(items))
        return [x * 2 for x in items]

    results = {}

    def call(i):
        results[i] = double(i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert results == {i: i * 2 for i in range(8)}
    assert max(seen_batches) > 1          # real coalescing happened
    assert sum(seen_batches) == 8

    # A non-list return surfaces as an error to the caller.
    @batch(max_batch_size=2, batch_wait_timeout_s=0.05)
    def bad(items):
        return 42

    with pytest.raises(TypeError, match="one per input"):
        bad("x")


def test_serve_batching_e2e(serve_cluster):
    @serve.deployment(max_ongoing_requests=8)
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def handle(self, items):
            self.batch_sizes.append(len(items))
            return [x + 100 for x in items]

        def __call__(self, x):
            return self.handle(x)

        def get_batch_sizes(self):
            return self.batch_sizes

    handle = serve.run(Batcher.bind(), name="batch_app")
    responses = [handle.remote(i) for i in range(16)]
    assert [r.result(timeout=60) for r in responses] == [
        i + 100 for i in range(16)]
    sizes = handle.get_batch_sizes.remote().result(timeout=60)
    assert sum(sizes) == 16
    assert max(sizes) > 1, sizes              # batched on the replica
    serve.delete("batch_app")


APP_BUILDER_MODULE = """
from ray_tpu_torch import serve

@serve.deployment(num_cpus=0.1)
class Doubler:
    def __call__(self, x):
        return x * 2

@serve.deployment(num_cpus=0.1)
class Ingress:
    def __init__(self, doubler, bias=0):
        self.doubler = doubler
        self.bias = bias
    def __call__(self, x):
        return self.doubler.remote(x).result(timeout=30) + self.bias

prebuilt = Ingress.bind(Doubler.bind())

def build(bias=0):
    return Ingress.bind(Doubler.bind(), bias=bias)
"""


def test_schema_validation_units():
    from ray_tpu_torch.serve.schema import DeploySchema, SchemaError

    ok = {"applications": [
        {"name": "a", "import_path": "m:app", "route_prefix": "/a",
         "deployments": [{"name": "D", "num_replicas": 2}]},
        {"name": "b", "import_path": "m:other"},
    ]}
    schema = DeploySchema.parse(ok)
    assert [a.name for a in schema.applications] == ["a", "b"]
    assert schema.applications[0].deployments[0].overrides == {
        "num_replicas": 2}

    with pytest.raises(SchemaError, match="applications"):
        DeploySchema.parse({})
    with pytest.raises(SchemaError, match="import_path"):
        DeploySchema.parse({"applications": [{"name": "x"}]})
    with pytest.raises(SchemaError, match="duplicate application"):
        DeploySchema.parse({"applications": [
            {"name": "a", "import_path": "m:x"},
            {"name": "a", "import_path": "m:y"}]})
    with pytest.raises(SchemaError, match="unknown field"):
        DeploySchema.parse({"applications": [
            {"name": "a", "import_path": "m:x", "replicas": 3}]})
    with pytest.raises(SchemaError, match="num_replicas"):
        DeploySchema.parse({"applications": [
            {"name": "a", "import_path": "m:x",
             "deployments": [{"name": "D", "num_replicas": -1}]}]})


def test_config_file_deploy(serve_cluster, tmp_path):
    """YAML config -> import_path app build -> per-deployment overrides
    land in the controller (reference: `serve deploy` + schema.py)."""
    import yaml

    (tmp_path / "cfg_app_mod.py").write_text(APP_BUILDER_MODULE)
    # The JAX package's own case imports a module of the same name in the
    # same test process: neither may find the other's in sys.modules.
    sys.modules.pop("cfg_app_mod", None)
    sys.path.insert(0, str(tmp_path))
    try:
        cfg = {"applications": [
            {"name": "cfg_app", "import_path": "cfg_app_mod:build",
             "route_prefix": "/cfg", "args": {"bias": 5},
             "deployments": [
                 {"name": "Doubler", "num_replicas": 2},
                 {"name": "Ingress", "max_ongoing_requests": 4},
             ]},
        ]}
        path = tmp_path / "serve.yaml"
        path.write_text(yaml.safe_dump(cfg))
        assert serve.deploy_config_file(str(path)) == ["cfg_app"]

        handle = serve.get_app_handle("cfg_app")
        assert handle.remote(10).result(timeout=60) == 25  # 10*2+5

        stat = {d["name"]: d for d in serve.status("cfg_app")}
        assert stat["Doubler"]["num_replicas"] == 2
        # Bound-Application import path works too; overrides must name
        # real deployments.
        serve.run(serve.import_application("cfg_app_mod:prebuilt"),
                  name="cfg_pre")
        assert serve.get_app_handle(
            "cfg_pre").remote(3).result(timeout=60) == 6
        with pytest.raises(ValueError, match="not present in app"):
            serve.run(serve.import_application("cfg_app_mod:prebuilt"),
                      name="cfg_bad", _overrides={"Nope": {}})
        serve.delete("cfg_app")
        serve.delete("cfg_pre")
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("cfg_app_mod", None)


def test_streaming_deployment_http_and_handle(serve_cluster):
    """Chunked streaming over the HTTP ingress and
    DeploymentResponseGenerator over Python handles (reference:
    `serve/_private/proxy.py` StreamingResponse over uvicorn)."""
    from ray_tpu_torch.serve.handle import DeploymentHandle

    @serve.deployment(stream=True, name="ChunkSource")
    class ChunkSource:
        def __call__(self, payload=None):
            for i in range(int(payload or 3)):
                yield f"c{i}\n"

    serve.run(ChunkSource.bind(), name="streamapp")
    proxy = serve.start()
    port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
    _routed("streamapp")

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/streamapp", data=b"4")
    resp = urllib.request.urlopen(req, timeout=60)
    lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert lines == ["c0", "c1", "c2", "c3"]

    handle = DeploymentHandle("streamapp", "ChunkSource")
    out = list(handle.options(stream=True).remote(2))
    assert out == ["c0\n", "c1\n"]
    serve.delete("streamapp")


def test_router_push_invalidation_latency(serve_cluster):
    """Replica-set changes reach existing routers by long-poll push, not
    a polling interval: after a redeploy bumps the routing version, the
    router converges well under a second (reference: LongPollHost)."""
    from ray_tpu_torch.serve.handle import DeploymentHandle

    @serve.deployment(name="Bumpy")
    class Bumpy:
        def __call__(self, payload=None):
            return "v1"

    serve.run(Bumpy.bind(), name="bumpapp")
    handle = DeploymentHandle("bumpapp", "Bumpy")
    assert handle.remote().result(timeout=60) == "v1"
    router = handle._get_router()
    v0 = router._version

    @serve.deployment(name="Bumpy", num_replicas=2)
    class Bumpy2:
        def __call__(self, payload=None):
            return "v2"

    serve.run(Bumpy2.bind(), name="bumpapp")
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and router._version == v0:
        time.sleep(0.05)
    waited = 5.0 - (deadline - time.monotonic())
    assert router._version != v0, "router never saw the new version"
    # Long-poll delivery is push-shaped: the update lands promptly.
    assert waited < 3.0, f"update took {waited:.1f}s — looks like polling"
    assert handle.remote().result(timeout=60) == "v2"
    serve.delete("bumpapp")


def test_grpc_ingress_unary_and_stream(serve_cluster):
    """gRPC ingress on the shared routing plane: unary predict with
    method + model selection via metadata, and a streamed response
    (reference: serve gRPC proxy + grpc_util)."""
    from ray_tpu_torch.serve.grpc_util import ServeGrpcClient

    @serve.deployment(name="GrpcEcho")
    class GrpcEcho:
        def __call__(self, payload=None):
            return {"echo": payload}

        def double(self, payload=0):
            return 2 * payload

    serve.run(GrpcEcho.bind(), name="grpcapp")
    proxy = serve.start_grpc()
    port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
    client = ServeGrpcClient(f"127.0.0.1:{port}")
    try:
        out = json.loads(client.predict({"x": 1}, application="grpcapp"))
        assert out == {"echo": {"x": 1}}
        out = json.loads(client.predict(21, application="grpcapp",
                                        method="double"))
        assert out == 42

        @serve.deployment(stream=True, name="GrpcChunks")
        class GrpcChunks:
            def __call__(self, payload=None):
                for i in range(int(payload or 3)):
                    yield f"g{i}"

        serve.run(GrpcChunks.bind(), name="grpcstream")
        chunks = [c.decode() for c in client.predict_stream(
            3, application="grpcstream")]
        assert chunks == ["g0", "g1", "g2"]
    finally:
        client.close()
        serve.delete("grpcapp")
        serve.delete("grpcstream")


def _calc_req_deser(raw: bytes):
    import json as _json

    return _json.loads(raw.decode())


def _calc_resp_ser(value) -> bytes:
    import json as _json

    return _json.dumps(value).encode()


def add_CalcServicer_to_server(servicer, server):
    """Shaped exactly like protoc-generated code (grpcio-tools is not in
    this image): a handler dict wrapped via method_handlers_generic_
    handler — the registration surface the proxy's harvest shim captures."""
    import grpc

    rpc_method_handlers = {
        "Square": grpc.unary_unary_rpc_method_handler(
            servicer.Square, request_deserializer=_calc_req_deser,
            response_serializer=_calc_resp_ser),
        "Counts": grpc.unary_stream_rpc_method_handler(
            servicer.Counts, request_deserializer=_calc_req_deser,
            response_serializer=_calc_resp_ser),
    }
    generic_handler = grpc.method_handlers_generic_handler(
        "test.Calc", rpc_method_handlers)
    server.add_generic_rpc_handlers((generic_handler,))


def test_grpc_user_defined_servicer(serve_cluster):
    """User-proto servicers on the gRPC ingress (reference:
    grpc_servicer_functions + gRPCGenericServer): the proxy serves the
    servicer's own method paths with its own (de)serializers; the
    deployment method named after the rpc receives the DESERIALIZED
    request."""
    import grpc

    from ray_tpu_torch.serve.api import _GRPC_PROXY_NAME

    @serve.deployment(name="CalcDep")
    class Calc:
        def Square(self, req):
            return {"y": req["x"] ** 2}

    @serve.deployment(stream=True, name="CalcStream")
    class CalcStream:
        def Counts(self, req):
            for i in range(req["n"]):
                yield {"i": i}

    serve.run(Calc.bind(), name="calcapp")
    serve.run(CalcStream.bind(), name="calcstream")
    # The detached proxy may exist from an earlier test WITHOUT the
    # servicer functions; recreate it with them.
    try:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(_GRPC_PROXY_NAME))
        time.sleep(0.5)
    except Exception:
        pass
    proxy = serve.start_grpc(
        grpc_servicer_functions=[add_CalcServicer_to_server])
    port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        square = channel.unary_unary(
            "/test.Calc/Square",
            request_serializer=_calc_resp_ser,
            response_deserializer=_calc_req_deser)
        out = square({"x": 7}, timeout=60,
                     metadata=[("application", "calcapp")])
        assert out == {"y": 49}

        counts = channel.unary_stream(
            "/test.Calc/Counts",
            request_serializer=_calc_resp_ser,
            response_deserializer=_calc_req_deser)
        got = list(counts({"n": 3}, timeout=60,
                          metadata=[("application", "calcstream")]))
        assert got == [{"i": 0}, {"i": 1}, {"i": 2}]

        # Unknown rpc paths still 404 (UNIMPLEMENTED from grpc core).
        bogus = channel.unary_unary("/test.Calc/Nope",
                                    request_serializer=_calc_resp_ser,
                                    response_deserializer=_calc_req_deser)
        with pytest.raises(grpc.RpcError):
            bogus({}, timeout=10, metadata=[("application", "calcapp")])
    finally:
        channel.close()
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(_GRPC_PROXY_NAME))
        except Exception:
            pass
        serve.delete("calcapp")
        serve.delete("calcstream")


def test_asgi_query_decoding_and_duplicate_headers():
    """Query values reach handlers percent-decoded ('+' included) and
    duplicate headers survive both directions."""
    from ray_tpu_torch.serve.asgi import App, Response, run_asgi_request

    app = App()

    @app.get("/echo")
    def echo(request):
        return Response(
            {"q": request.query_params.get("q"),
             "tags": [v for k, v in request.query_params_list
                      if k == "tag"],
             "cookies": [v for k, v in request.header_list
                         if k == "cookie"]},
            headers=[("set-cookie", "a=1"), ("set-cookie", "b=2")])

    rep = run_asgi_request(app, {
        "method": "GET", "path": "/echo",
        "query_string": "q=red+hat%2F7&tag=x&tag=y",
        "headers": [("cookie", "s=1"), ("cookie", "t=2")],
    })
    assert rep["status"] == 200
    out = json.loads(rep["body"])
    assert out["q"] == "red hat/7"
    assert out["tags"] == ["x", "y"]
    assert out["cookies"] == ["s=1", "t=2"]
    assert [v for k, v in rep["header_list"]
            if k == "set-cookie"] == ["a=1", "b=2"]

    # A dict headers payload (older proxy wire format) still works.
    rep = run_asgi_request(app, {
        "method": "GET", "path": "/echo", "query_string": "q=%2B1",
        "headers": {"cookie": "only=1"},
    })
    assert json.loads(rep["body"])["q"] == "+1"
    assert json.loads(rep["body"])["cookies"] == ["only=1"]


def test_asgi_ingress_fastapi_style(serve_cluster):
    """@serve.ingress(app) routes HTTP through an ASGI app with path
    params, querystrings and JSON bodies (reference: FastAPI ingress via
    http_util.ASGIAppReplicaWrapper)."""
    app = serve.asgi.App()

    @app.get("/items/{item_id}")
    def get_item(request):
        return {"item_id": request.path_params["item_id"],
                "q": request.query_params.get("q", ""),
                "scale": request.scope["deployment"].scale}

    @app.post("/items")
    async def add_item(request):
        body = request.json()
        return serve.asgi.Response({"added": body["name"]}, status=201)

    @serve.deployment(name="AsgiApp")
    @serve.ingress(app)
    class AsgiApp:
        def __init__(self, scale=10):
            self.scale = scale

    serve.run(AsgiApp.bind(3), name="shop")
    proxy = serve.start()
    port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
    _routed("shop")
    base = f"http://127.0.0.1:{port}/shop"
    try:
        with urllib.request.urlopen(f"{base}/items/7?q=red",
                                    timeout=60) as resp:
            out = json.loads(resp.read())
        assert out == {"item_id": "7", "q": "red", "scale": 3}
        req = urllib.request.Request(
            f"{base}/items", data=json.dumps({"name": "hat"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 201
            assert json.loads(resp.read()) == {"added": "hat"}
        try:
            urllib.request.urlopen(f"{base}/nope", timeout=60)
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        serve.delete("shop")


# ------------------------ parity with the JAX package's jax-free functions

ASGI_CASES = [
    ("/items/{item_id}", "GET", "/items/7", "q=red"),
    ("/items/{item_id}", "GET", "/items/7/", "q=red+hat%2F7&q=second"),
    ("/u/{user}/posts/{post}", "GET", "/u/ann/posts/12", "a=%26&b=%3D&c"),
    ("/files/{name}.txt", "GET", "/files/readme.txt", ""),
    ("/files/{name}.txt", "GET", "/files/readmeXtxt", ""),
    ("/v1+v2/{x}", "POST", "/v1+v2/3", "z=%E2%9C%93&z=+"),
    ("/v1+v2/{x}", "POST", "/v11v2/3", ""),
    ("/", "GET", "/", "k=%zz&empty=&flag"),
    ("/items/{item_id}", "PUT", "/items/7", ""),
]


def _asgi_run(mod, template, method, path, query):
    app = mod.App()

    @app.route(template, methods=("GET", "POST"))
    def handler(request):
        return {"params": request.path_params,
                "query": request.query_params_list,
                "query_dict": request.query_params,
                "headers": request.header_list,
                "joined": request.headers}

    return mod.run_asgi_request(app, {
        "method": method, "path": path, "query_string": query,
        "headers": [("X-Tag", "a"), ("x-tag", "b"), ("Cookie", "c=1")],
        "body": b""})


@pytest.mark.parametrize("case", ASGI_CASES, ids=lambda c: f"{c[1]} {c[2]}")
def test_asgi_decoding_equals_the_jax_package_s(case):
    from ray_tpu.serve import asgi as ref
    from ray_tpu_torch.serve import asgi as port

    assert _asgi_run(port, *case) == _asgi_run(ref, *case)


def _form_batches(mod, waves, max_size, wait_s=0.75):
    """Drive ``mod``'s ``@batch`` with a fixed arrival sequence: ``waves``
    of items arriving one at a time, each wave's batches formed before the
    next wave arrives; every call of the wrapped function is held until
    all items have arrived, so no batch forms out of a race. Returns the
    batches and each caller's result."""
    gate = threading.Event()
    batches = []

    @mod.batch(max_batch_size=max_size, batch_wait_timeout_s=wait_s)
    def fn(items):
        batches.append(list(items))
        gate.wait(60)
        if -1 in items:
            raise ValueError(f"bad batch {items}")
        return [10 * x for x in items]

    queue = fn._queue_for(None)
    results, threads, n = {}, [], 0

    def call(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — compared as text
            results[i] = f"{type(e).__name__}: {e}"

    def settled(pending):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with queue._lock:
                queued = len(queue._items)
            batched = sum(len(b) for b in batches)
            if batched + queued == n and queued == pending:
                return
            time.sleep(0.002)
        raise AssertionError(f"{n} items: {batches}, {queued} queued")

    for wave in waves:
        for k, item in enumerate(wave, 1):
            t = threading.Thread(target=call, args=(item,))
            t.start()
            threads.append(t)
            n += 1
            # Arrived: queued behind the wave's leader, or taken in the
            # batch it filled.
            settled(k % max_size)
        settled(0)                # the wave's last batch timed out
    gate.set()
    for t in threads:
        t.join(60)
    return batches, results


BATCH_CASES = [
    ([[0, 1, 2, 3, 4, 5, 6, 7]], 4),
    ([[0, 1, 2], [3, 4, 5, 6, 7]], 4),
    ([[0], [1, 2, 3, 4, 5], [6, 7]], 3),
    ([[0, 1, -1, 3, 4], [5]], 2),
]


@pytest.mark.parametrize("waves,max_size", BATCH_CASES,
                         ids=lambda c: str(c))
def test_batch_formation_equals_the_jax_package_s(waves, max_size):
    from ray_tpu.serve import batching as ref
    from ray_tpu_torch.serve import batching as port

    got = _form_batches(port, waves, max_size)
    want = _form_batches(ref, waves, max_size)
    assert got == want
    # Each wave splits into batches of max_size in arrival order.
    assert got[0] == [w[i:i + max_size] for w in waves
                      for i in range(0, len(w), max_size)]


SCHEMA_CASES = [
    {"applications": [
        {"name": "a", "import_path": "m:app", "route_prefix": "/a",
         "args": {"k": 1},
         "deployments": [{"name": "D", "num_replicas": 2,
                          "max_ongoing_requests": 4}]},
        {"name": "b", "import_path": "m.sub:other"}]},
    {"applications": [{"import_path": "m:app"}]},
    {"applications": [{"import_path": "m:app",
                       "deployments": [{"name": "D",
                                        "num_replicas": "auto"}]}]},
    {"applications": [{"import_path": "m:app", "deployments": [
        {"name": "D", "autoscaling_config": {"min_replicas": 1,
                                             "max_replicas": 4}}]}]},
    {},
    {"applications": [{"name": "x"}]},
    {"applications": [{"name": "x", "import_path": "no_colon"}]},
    {"applications": [{"import_path": "m:a"}, {"import_path": "m:b"}]},
    {"applications": [{"name": "a", "import_path": "m:x"},
                      {"name": "a", "import_path": "m:y"}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "route_prefix": "/p"},
                      {"name": "b", "import_path": "m:y",
                       "route_prefix": "/p"}]},
    {"applications": [{"name": "a", "import_path": "m:x", "replicas": 3}]},
    {"applications": [{"name": "a", "import_path": "m:x", "args": [1]}]},
    {"applications": ["not a mapping"]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"num_replicas": 1}]}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"name": "D", "num_replicas": -1}]}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"name": "D", "num_replicas": 1.5}]}]},
    {"applications": [{"name": "a", "import_path": "m:x",
                       "deployments": [{"name": "D", "bogus": 1}]}]},
    {"applications": [{"name": "a", "import_path": "m:x", "deployments": [
        {"name": "D", "autoscaling_config": [1]}]}]},
    {"applications": [{"name": "a", "import_path": "m:x", "deployments": [
        {"name": "D", "autoscaling_config": {"min_replicas": 5,
                                             "max_replicas": 2}}]}]},
]


def _parse(mod, raw):
    try:
        return ("ok", dataclasses.asdict(mod.DeploySchema.parse(raw)))
    except Exception as e:  # noqa: BLE001 — compared by type and text
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("raw", SCHEMA_CASES, ids=range(len(SCHEMA_CASES)))
def test_schema_validation_equals_the_jax_package_s(raw):
    from ray_tpu.serve import schema as ref
    from ray_tpu_torch.serve import schema as port

    assert _parse(port, raw) == _parse(ref, raw)


def test_schema_takes_num_gpus_where_the_reference_takes_num_tpus():
    """The one field that differs: a deployment's share of the card."""
    from ray_tpu_torch.serve.schema import DeploySchema, SchemaError

    raw = {"applications": [{"name": "a", "import_path": "m:x",
                             "deployments": [{"name": "D",
                                              "num_gpus": 0.5}]}]}
    assert DeploySchema.parse(raw).applications[0].deployments[
        0].overrides == {"num_gpus": 0.5}
    raw["applications"][0]["deployments"][0] = {"name": "D",
                                                "num_tpus": 1}
    with pytest.raises(SchemaError, match="unknown field"):
        DeploySchema.parse(raw)


# ---------------------------------------------------- the wire contract


@serve.deployment(name="Wire")
class Wire:
    def __call__(self, payload="no argument"):
        if payload == "fail":
            raise ValueError("asked to fail")
        return {"got": payload, "type": type(payload).__name__}


@pytest.fixture(scope="module")
def wire(port):
    handle = serve.run(Wire.bind(), name="wire")
    _routed("wire")
    yield handle
    serve.delete("wire")


def test_unknown_app_is_404_naming_it(port):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(port, "/no_such_app/x"), timeout=30)
    assert e.value.code == 404
    assert json.loads(e.value.read()) == {
        "error": "no application 'no_such_app'"}


def test_failed_call_is_500_with_type_and_message(port, wire):
    with pytest.raises(Exception) as direct:
        wire.remote("fail").result(timeout=60)
    want = f"{type(direct.value).__name__}: {direct.value}"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/wire", b'"fail"')
    assert e.value.code == 500
    body = json.loads(e.value.read())
    assert body == {"error": want}
    assert "asked to fail" in body["error"]


def test_json_and_text_bodies(port, wire):
    for raw, want in ((b'{"a": [1, 2]}', {"a": [1, 2]}), (b"7", 7),
                      (b"plain words", "plain words"),
                      (b"caf\xe9 {", "caf� {")):
        status, body = _post(port, "/wire", raw)
        assert status == 200
        assert json.loads(body) == {"result": {
            "got": want, "type": type(want).__name__}}


def test_empty_body_means_no_argument(port, wire):
    status, body = _post(port, "/wire", b"")
    assert status == 200
    assert json.loads(body) == {"result": {"got": "no argument",
                                           "type": "str"}}
    with urllib.request.urlopen(_url(port, "/wire"), timeout=60) as resp:
        assert json.loads(resp.read())["result"]["got"] == "no argument"


def test_healthz_and_routes(port, wire):
    with urllib.request.urlopen(_url(port, "/-/healthz"), timeout=30) as r:
        assert r.headers["Content-Type"].startswith("application/json")
        assert json.loads(r.read()) == {"ok": True}
    with urllib.request.urlopen(_url(port, "/-/routes"), timeout=30) as r:
        routes = json.loads(r.read())
    assert routes["wire"] == "/wire"


def test_stream_chunk_encodings_and_flush(port, tmp_path):
    """bytes and str chunks pass as they are, anything else as one JSON
    line; each chunk is flushed: the client reads the first line while
    the generator still waits for the file it creates after reading."""
    flag = tmp_path / "go"

    @serve.deployment(stream=True, name="Chunks")
    class Chunks:
        def __call__(self, payload=None):
            import os as _os
            import time as _time

            yield "first line\n"
            deadline = _time.monotonic() + 60
            while not _os.path.exists(payload["flag"]):
                if _time.monotonic() > deadline:
                    raise TimeoutError("the client never read line one")
                _time.sleep(0.01)
            yield b"raw bytes\n"
            yield {"k": [1, 2]}
            yield 3
            yield ""
            yield "last"

    serve.run(Chunks.bind(), name="chunks")
    _routed("chunks")
    try:
        req = urllib.request.Request(
            _url(port, "/chunks"),
            data=json.dumps({"flag": str(flag)}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.headers["Transfer-Encoding"] == "chunked"
            assert resp.headers["Content-Type"] == \
                "text/plain; charset=utf-8"
            assert resp.readline() == b"first line\n"
            flag.write_text("")
            rest = resp.read()
        assert rest == b'raw bytes\n{"k": [1, 2]}\n3\nlast'
    finally:
        serve.delete("chunks")


def test_asgi_duplicate_headers_and_query_through_the_proxy(port):
    app = serve.asgi.App()

    @app.get("/echo/{word}")
    def echo(request):
        return serve.asgi.Response(
            {"word": request.path_params["word"],
             "query": request.query_params_list,
             "cookies": [v for k, v in request.header_list
                         if k == "cookie"]},
            headers=[("set-cookie", "a=1"), ("set-cookie", "b=2"),
                     ("content-length", "999"), ("x-kept", "yes")])

    @serve.deployment(name="HeaderApp")
    @serve.ingress(app)
    class HeaderApp:
        pass

    serve.run(HeaderApp.bind(), name="hdr")
    _routed("hdr")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("GET", "/hdr/echo/caf%C3%A9?x=a%26b&x=c+d")
        conn.putheader("Cookie", "s=1")
        conn.putheader("Cookie", "t=2")
        conn.endheaders()
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200
        assert body == {"word": "café", "query": [["x", "a&b"],
                                                  ["x", "c d"]],
                        "cookies": ["s=1", "t=2"]}
        pairs = resp.getheaders()
        assert [v for k, v in pairs if k == "set-cookie"] == ["a=1", "b=2"]
        # The proxy frames the body itself: the replica's length goes.
        assert [v for k, v in pairs if k.lower() == "content-length"] == [
            str(len(json.dumps(body)))]
        assert ("x-kept", "yes") in pairs
        conn.close()
    finally:
        serve.delete("hdr")


def test_body_past_256_mib_is_413(port, wire):
    from ray_tpu_torch.serve._private.proxy import MAX_BODY_BYTES

    assert MAX_BODY_BYTES == 256 * 1024 * 1024
    out = _raw(port, b"POST /wire HTTP/1.1\r\nHost: x\r\nContent-Length: "
               + str(MAX_BODY_BYTES + 1).encode() + b"\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 413 ")
    out = _raw(port, b"POST /wire HTTP/1.1\r\nHost: x\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n"
               + b"%x\r\n" % (MAX_BODY_BYTES + 1))
    assert out.startswith(b"HTTP/1.1 413 ")
    # A large body within the limit is read whole (decoded off the loop).
    big = list(range(200_000))
    status, body = _post(port, "/wire", json.dumps(big).encode())
    assert status == 200 and json.loads(body)["result"]["got"] == big


def test_chunked_request_body(port, wire):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    parts = [b'{"par', b'ts": ', b'[1, 2, 3]', b"}"]
    conn.request("POST", "/wire", body=iter(parts), encode_chunked=True,
                 headers={"Transfer-Encoding": "chunked"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read()) == {"result": {
        "got": {"parts": [1, 2, 3]}, "type": "dict"}}
    conn.close()


def test_keep_alive_and_connection_close(port, wire):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/wire", body=b"1")
    first = conn.getresponse()
    assert json.loads(first.read())["result"]["got"] == 1
    sock = conn.sock
    conn.request("POST", "/wire", body=b"2")
    second = conn.getresponse()
    assert json.loads(second.read())["result"]["got"] == 2
    assert conn.sock is sock                  # one connection, two calls
    conn.request("POST", "/wire", body=b"3",
                 headers={"Connection": "close"})
    last = conn.getresponse()
    assert last.getheader("Connection") == "close"
    assert json.loads(last.read())["result"]["got"] == 3
    conn.close()
    # Two pipelined requests on one socket, the second closing it; an
    # HTTP/1.0 request closes after its answer.
    out = _raw(port, b"POST /wire HTTP/1.1\r\nContent-Length: 1\r\n\r\n4"
               b"POST /wire HTTP/1.1\r\nContent-Length: 1\r\n"
               b"Connection: close\r\n\r\n5")
    assert out.count(b"HTTP/1.1 200 ") == 2
    assert b'"got": 4' in out and b'"got": 5' in out
    out = _raw(port, b"GET /-/healthz HTTP/1.0\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 200 ") and out.endswith(b'{"ok": true}')


def test_malformed_request_is_400(port):
    out = _raw(port, b"NONSENSE\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 400 ")
    out = _raw(port, b"POST /wire HTTP/1.1\r\nContent-Length: x\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 400 ")


def test_every_node_proxy_binds_all_interfaces(serve_cluster):
    """EveryNode puts one proxy on each node, named after it, listening
    on 0.0.0.0; it answers as the head proxy does."""
    node = next(n for n in ray_tpu_torch.nodes() if n["Alive"])
    name = f"SERVE_PROXY:{node['NodeID'][:12]}"
    proxy = serve.start(proxy_location="EveryNode")
    try:
        port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=60)
        assert ray_tpu_torch.get_actor(name)
        with urllib.request.urlopen(_url(port, "/-/healthz"),
                                    timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        # Its listening socket, as the kernel lists it: 0.0.0.0:port.
        rows = Path(f"/proc/{_proxy_pid(name)}/net/tcp").read_text()
        listening = [line.split()[1] for line in rows.splitlines()[1:]
                     if line.split()[3] == "0A"]
        assert f"00000000:{port:04X}" in listening, listening
    finally:
        ray_tpu_torch.kill(proxy)


def _proxy_pid(name="SERVE_PROXY"):
    from ray_tpu_torch.util import state

    wid = next(a["worker_id"] for a in state.list_actors()
               if a["name"] == name and a["state"] != "DEAD")
    return next(w["pid"] for w in state.list_workers()
                if w["worker_id"] == wid)


def test_proxy_source_imports_no_aiohttp_or_multidict():
    path = ROOT / "ray_tpu_torch" / "serve" / "_private" / "proxy.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"aiohttp", "multidict", "yarl"}, mods
    assert mods <= {"__future__", "asyncio", "concurrent", "http", "json",
                    "threading", "time", "urllib", "typing",
                    "ray_tpu_torch"}, mods


# --------------------------------------------------- the LLM over HTTP

_CACHE = {}


def _jax_model():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as J

    if "jax" not in _CACHE:
        jc = J.LlamaConfig.tiny(dtype=jnp.float32)
        jp = J.init_params(jc, jax.random.key(0))
        _CACHE["jax"] = (jc, jp, jax.tree_util.tree_map(np.asarray, jp))
    return _CACHE["jax"]


def _reference(prompt, n):
    import jax.numpy as jnp

    from ray_tpu.models import llama as J

    jc, jp, _ = _jax_model()
    return np.asarray(J.generate(jp, jnp.asarray([prompt], jnp.int32), jc,
                                 max_new_tokens=n))[0].tolist()


def _loader(tree):
    """A zero-arg params_loader over the JAX package's numpy tree; it
    converts in the replica's process, which imports no JAX."""
    def load():
        import torch

        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.models.llama import LlamaConfig

        return params_from_numpy(
            tree, LlamaConfig.tiny(dtype=torch.float32), "cpu")
    return load


@pytest.mark.parametrize("builder", ["build_llm_app", "build_routed_llm_app"])
def test_llm_over_http_tokens_equal_jax_generate(port, builder):
    """A POST of {"prompt", "max_tokens"} reaches ``LLMServer.__call__``
    as the decoded dict; the reply JSON-encodes (tokens a list of ints,
    the router's x-trace-id a string) and its greedy tokens equal the
    JAX package's ``generate``. The proxy's process loads no torch."""
    torch = pytest.importorskip("torch")
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve import llm

    kwargs = dict(model_config=LlamaConfig.tiny(dtype=torch.float32),
                  engine_config={"num_slots": 2, "max_seq_len": 160,
                                 "prefill_buckets": (16, 128)},
                  quantize="bf16", params_loader=_loader(_jax_model()[2]),
                  device="cpu")
    if builder == "build_routed_llm_app":
        kwargs["num_replicas"] = 1
    handle = serve.run(getattr(llm, builder)(**kwargs), name="llmhttp")
    _routed("llmhttp")
    rng = np.random.RandomState(5)
    reqs = [{"prompt": rng.randint(0, 256, n).tolist(), "max_tokens": m}
            for n, m in ((3, 6), (20, 8), (40, 5))]
    try:
        for req in reqs:
            status, body = _post(port, "/llmhttp", json.dumps(req).encode(),
                                 headers={"Content-Type":
                                          "application/json"}, timeout=120)
            assert status == 200
            out = json.loads(body)["result"]
            assert out["tokens"] == _reference(req["prompt"],
                                               req["max_tokens"])
            assert all(type(t) is int for t in out["tokens"])
            assert out["num_tokens"] == req["max_tokens"]
            direct = handle.remote(req).result(timeout=120)
            assert json.loads(json.dumps(direct))["tokens"] == out["tokens"]
            if builder == "build_routed_llm_app":
                assert isinstance(out["x-trace-id"], str)
                assert len(out["x-trace-id"]) == 32
        pid = _proxy_pid()
        maps = Path(f"/proc/{pid}/maps").read_text()
        assert "libtorch" not in maps and "libcuda" not in maps
        env = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
        assert b"CUDA_VISIBLE_DEVICES=" in env
    finally:
        serve.delete("llmhttp")
