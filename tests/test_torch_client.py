"""The ``ray_tpu_torch://`` thin client and the C++ frontend on the port
(``ray_tpu_torch.client``, ``ray_tpu_torch.cross_language``): every case
of the reference's own ``tests/test_client.py`` and
``tests/test_cpp_client.py``, asserting what it asserts there, against
the port's cluster (the unchanged ``cpp/`` demo built into a temporary
directory); the value codec held to the JAX package's byte for byte;
a msgpack frame without msgpack refused naming its slice; the kept
fault of the reference's single-session pins (ROADMAP C, F18); and the
slice as a whole: a thin client with no card visible drives a
``num_gpus=1`` serving actor (the GPU faked, the server on the CPU) to
the JAX package's greedy tokens, and the cluster gets the GPU back once
it has gone. One cluster for the module; every wait has a timeout.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import client as rt_client
from ray_tpu_torch import cross_language

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(ROOT, "cpp")


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=1,
                              object_store_memory=128 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture
def server(cluster):
    srv = rt_client.serve(0, host="127.0.0.1")
    yield srv
    srv.stop()


def _client_env(**extra):
    return {**os.environ, "PYTHONPATH": ROOT, **extra}


def _wait_for(pred, timeout=30.0, period=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return pred()


CLIENT_SCRIPT = """
import ray_tpu_torch

ray_tpu_torch.init(address="ray_tpu_torch://127.0.0.1:{port}")

@ray_tpu_torch.remote
def square(x):
    return x * x

# tasks + composition (ref as arg crosses the proxy as a marker)
refs = [square.remote(i) for i in range(5)]
assert ray_tpu_torch.get(refs, timeout=60) == [0, 1, 4, 9, 16]
chained = square.remote(refs[3])
assert ray_tpu_torch.get(chained, timeout=60) == 81

# put / wait
data = ray_tpu_torch.put({{"k": [1, 2, 3]}})
assert ray_tpu_torch.get(data, timeout=30)["k"] == [1, 2, 3]
ready, rest = ray_tpu_torch.wait(refs, num_returns=2, timeout=30)
assert len(ready) == 2 and len(rest) == 3

# actors end to end, incl. passing the handle through a task
@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0
    def incr(self, by=1):
        self.n += by
        return self.n

c = Counter.options(name="client_counter").remote()
assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
assert ray_tpu_torch.get(c.incr.remote(4), timeout=60) == 5

@ray_tpu_torch.remote
def poke(counter):
    return ray_tpu_torch.get(counter.incr.remote(10), timeout=30)

assert ray_tpu_torch.get(poke.remote(c), timeout=60) == 15

# a ref nested inside a custom object still resolves server-side
class Holder:
    def __init__(self, ref):
        self.ref = ref

@ray_tpu_torch.remote
def unwrap(holder):
    return ray_tpu_torch.get(holder.ref, timeout=30) + 1

assert ray_tpu_torch.get(unwrap.remote(Holder(refs[2])), timeout=60) == 5

# named-actor lookup through the proxy
again = ray_tpu_torch.get_actor("client_counter")
assert ray_tpu_torch.get(again.incr.remote(), timeout=60) == 16

# cluster state passthrough
nodes = ray_tpu_torch.nodes()
assert len(nodes) == 1 and nodes[0]["Alive"]

ray_tpu_torch.kill(c)
ray_tpu_torch.shutdown()
print("CLIENT-OK")
"""


def test_thin_client_end_to_end(server, tmp_path):
    script = tmp_path / "client_driver.py"
    script.write_text(CLIENT_SCRIPT.format(port=server.port))
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=180, env=_client_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLIENT-OK" in proc.stdout


def test_client_release_unpins_server_refs(server):
    from ray_tpu_torch.client.worker import ClientWorker

    w = ClientWorker("127.0.0.1", server.port)
    ref = w.put([1, 2, 3])
    oid = ref.binary()
    assert oid in server._refs
    # In client mode the global worker IS the ClientWorker and
    # ObjectRef GC drives this counter; here (a second worker beside
    # a real driver) exercise the protocol directly.
    w.reference_counter.add_local_ref(oid)
    w.reference_counter.remove_local_ref(oid)
    assert _wait_for(lambda: oid not in server._refs, 10), \
        "server pin never released"
    w.shutdown()


GC_CLIENT_SCRIPT = """
import gc
import os
import time

import ray_tpu_torch

ray_tpu_torch.init(address="ray_tpu_torch://127.0.0.1:{port}")

ref = ray_tpu_torch.put(list(range(100)))
with open({oid_path!r}, "w") as f:
    f.write(ref.binary().hex())
del ref
gc.collect()
with open({dropped_path!r}, "w") as f:
    f.write("dropped")
# Keep the session ALIVE while the test checks the server pin was
# released mid-session.
deadline = time.monotonic() + 60
while time.monotonic() < deadline and not os.path.exists({ack_path!r}):
    time.sleep(0.05)
assert os.path.exists({ack_path!r}), "test never acked"
ray_tpu_torch.shutdown()
print("GC-CLIENT-OK")
"""


def test_client_refs_gc_without_explicit_release(server, tmp_path):
    """ObjectRef.__del__ in client mode must release the server-side pin
    mid-session, not only at disconnect."""
    oid_path = str(tmp_path / "oid")
    dropped_path = str(tmp_path / "dropped")
    ack_path = str(tmp_path / "ack")
    script = tmp_path / "gc_client.py"
    script.write_text(GC_CLIENT_SCRIPT.format(
        port=server.port, oid_path=oid_path, dropped_path=dropped_path,
        ack_path=ack_path))
    proc = subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_client_env())
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(dropped_path):
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            assert time.monotonic() < deadline, "client never dropped"
            time.sleep(0.05)
        with open(oid_path) as f:
            oid = bytes.fromhex(f.read().strip())
        still_pinned = not _wait_for(lambda: oid not in server._refs, 15)
        with open(ack_path, "w") as f:
            f.write("ack")
        out, _ = proc.communicate(timeout=60)
        assert not still_pinned, (
            "GC'd client ObjectRef never released its server pin "
            "mid-session")
        assert proc.returncode == 0, out[-3000:]
        assert "GC-CLIENT-OK" in out
    finally:
        if proc.poll() is None:
            proc.kill()


def test_one_clients_disconnect_drops_every_pin(server):
    """F18, kept from the reference: the server keeps one set of pins for
    all its clients, so one client's disconnect releases another's (and
    a client that dies without disconnecting leaves its pins)."""
    from ray_tpu_torch.client.worker import ClientWorker

    a = ClientWorker("127.0.0.1", server.port)
    b = ClientWorker("127.0.0.1", server.port)
    ref = a.put("a's value")
    assert ref.binary() in server._refs
    b.shutdown()
    assert ref.binary() not in server._refs
    with pytest.raises(Exception, match="unknown/released"):
        a.get_objects([ref], timeout=10)
    a.shutdown()


def test_other_address_schemes_are_refused():
    with pytest.raises(ValueError, match="ray_tpu_torch://"):
        ray_tpu_torch.init(address="ray_tpu://127.0.0.1:1")


# -------------------------------------------------------- msgpack frames
def test_msgpack_frame_without_msgpack_names_its_slice(server, monkeypatch,
                                                       capfd):
    """A cross-language frame reaching a process without msgpack is
    refused with an error naming what needs it, and the connection
    closes; pickle frames on other connections are unaffected."""
    from ray_tpu_torch._private import rpc

    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="cross-language"):
        rpc._msgpack()
    body = b"\x94\x01\x00\xabclient_ping\x80"   # [1, 0, "client_ping", {}]
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=30) as s:
        s.sendall(struct.pack(">Q", len(body)) + body)
        assert s.recv(1) == b""                  # closed, no reply
    assert "driver transports" in capfd.readouterr().err
    from ray_tpu_torch.client.worker import ClientWorker

    w = ClientWorker("127.0.0.1", server.port)
    assert w._client.call("client_ping", timeout=15) is True
    w.shutdown()


# ------------------------------------------------------------ the codec
def _codec_tree():
    return {"a": [1, -2, 3.5, "s", b"b", None, True],
            "nd": np.arange(6, dtype=np.int32).reshape(2, 3),
            "f": np.float32(0.25), "nest": ({"x": np.zeros((0, 2))},)}


def test_msgpack_value_codec_roundtrip():
    """The C++ msgpack_lite subset against the Python msgpack encoder:
    cross-decode both directions through the cross_language value codec."""
    import msgpack

    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    tree = {"a": [1, -2, 3.5, "s", b"b", None, True],
            "nd": cross_language.encode(arr)}
    packed = msgpack.packb(tree, use_bin_type=True)
    back = msgpack.unpackb(packed, raw=False)
    dec = cross_language.decode(back)
    assert dec["a"][:3] == [1, -2, 3.5]
    np.testing.assert_array_equal(dec["nd"], arr)


def test_codec_bytes_equal_the_jax_package():
    """``encode`` gives the same msgpack bytes as the JAX package's for
    the same tree, and each package decodes the other's bytes to equal
    values."""
    import msgpack

    pytest.importorskip("jax")
    from ray_tpu import cross_language as jxl

    tree = _codec_tree()
    ours = msgpack.packb(cross_language.encode(tree), use_bin_type=True)
    theirs = msgpack.packb(jxl.encode(tree), use_bin_type=True)
    assert ours == theirs
    for data, decode in ((ours, jxl.decode), (theirs, cross_language.decode)):
        got = decode(msgpack.unpackb(data, raw=False))
        np.testing.assert_array_equal(got["nd"], tree["nd"])
        assert got["nd"].dtype == np.int32 and got["f"] == 0.25
        assert got["nest"][0]["x"].shape == (0, 2)
    with pytest.raises(TypeError, match="language boundary"):
        cross_language.encode(object())


# ------------------------------------------------------ the C++ frontend
def _xlang_matmul_t(m):
    """Cluster-side torch compute on a C++-shipped array: m @ m.T."""
    import torch

    t = torch.tensor(m)
    return (t @ t.T).numpy()


def _xlang_square(x):
    return x * x


def _xlang_boom():
    raise RuntimeError("boom from the cluster")


@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    """The unchanged ``cpp/`` sources built into a directory of this
    test's own (never ``cpp/build``, which the reference's tests use)."""
    out = tmp_path_factory.mktemp("cpp_build")
    subprocess.run(["make", "-s", f"BUILD={out}"], cwd=CPP, check=True,
                   timeout=300)
    return out


@pytest.fixture(scope="module")
def cpp_binary(cpp_build):
    path = os.path.join(cpp_build, "xlang_demo")
    assert os.path.exists(path)
    return path


@pytest.fixture(scope="module")
def cpp_tasks_lib(cpp_build):
    path = os.path.join(cpp_build, "libtasks.so")
    assert os.path.exists(path), path
    return path


def test_cpp_client_end_to_end(cluster, cpp_binary, cpp_tasks_lib):
    from ray_tpu_torch.client.server import serve

    cross_language.register("xlang_matmul_t", _xlang_matmul_t)
    cross_language.register("xlang_square", _xlang_square)
    cross_language.register("xlang_boom", _xlang_boom)
    # C++-to-C++ circle: the C++ driver calls a C++ task-library fn and
    # drives a C++ actor class.
    cross_language.register(
        "cpp_fib", cross_language.cpp_function(cpp_tasks_lib, "fib"))
    cross_language.register(
        "CppCounter",
        cross_language.cpp_actor_class(cpp_tasks_lib, "Counter"))
    srv = serve(port=0, host="127.0.0.1")
    try:
        proc = subprocess.run([cpp_binary, str(srv.port), "with_cpp_tasks"],
                              capture_output=True, text=True, timeout=180)
        print(proc.stdout)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        assert len(lines) >= 14
        assert all(ln.startswith("PASS") for ln in lines), proc.stdout
        for probe in ("cpp_to_cpp_task", "cpp_to_cpp_actor",
                      "cpp_actor_ndarray", "cpp_actor_survives_error",
                      "cpp_named_actor_lookup"):
            assert any(probe in ln for ln in lines), (probe, proc.stdout)
    finally:
        srv.stop()


def test_cpp_function_as_cluster_task(cluster, cpp_tasks_lib):
    """C++ task-library functions run as ordinary cluster tasks
    (reference: cpp worker RAY_REMOTE; architecture note in
    task_lib.hpp)."""
    fib = ray_tpu_torch.remote(cross_language.cpp_function(cpp_tasks_lib,
                                                           "fib"))
    assert ray_tpu_torch.get(fib.remote(20), timeout=120) == 6765

    scale = ray_tpu_torch.remote(cross_language.cpp_function(cpp_tasks_lib,
                                                             "scale"))
    out = ray_tpu_torch.get(
        scale.remote(np.array([1.0, 2.0], np.float32), 3.0), timeout=120)
    np.testing.assert_allclose(out, [3.0, 6.0])

    boom = ray_tpu_torch.remote(cross_language.cpp_function(cpp_tasks_lib,
                                                            "fail"))
    with pytest.raises(Exception, match="exploded"):
        ray_tpu_torch.get(boom.remote(), timeout=120)


def test_cpp_actor_class_as_cluster_actor(cluster, cpp_tasks_lib):
    """C++ actor classes run as ordinary cluster actors from Python
    (reference: cpp worker RAY_REMOTE actor classes; architecture note
    in task_lib.hpp)."""
    Counter = ray_tpu_torch.remote(
        cross_language.cpp_actor_class(cpp_tasks_lib, "Counter"))
    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.inc.remote(), timeout=60) == 11
    assert ray_tpu_torch.get(c.inc.remote(5), timeout=60) == 16
    out = ray_tpu_torch.get(
        c.accumulate.remote(np.array([1.0, 2.0], np.float32)), timeout=60)
    assert out == 19

    # C++ exceptions surface as task errors; state survives.
    with pytest.raises(Exception, match="exploded"):
        ray_tpu_torch.get(c.fail.remote(), timeout=60)
    assert ray_tpu_torch.get(c.get.remote(), timeout=60) == 19

    # Two instances do not share state.
    c2 = Counter.remote()
    assert ray_tpu_torch.get(c2.get.remote(), timeout=60) == 0
    ray_tpu_torch.kill(c)
    ray_tpu_torch.kill(c2)


def test_cpp_function_shipped_via_working_dir(cluster, cpp_tasks_lib,
                                              tmp_path):
    """Ship the .so via runtime_env working_dir and reference it by
    RELATIVE path — the worker resolves it in its unpacked working dir."""
    import shutil

    shutil.copy(cpp_tasks_lib, tmp_path / "shipped_tasks.so")
    fib = ray_tpu_torch.remote(cross_language.cpp_function(
        "shipped_tasks.so", "fib"))
    fib = fib.options(runtime_env={"working_dir": str(tmp_path)})
    assert ray_tpu_torch.get(fib.remote(10), timeout=120) == 55


# ------------------------------------------------ the slice, on the CPU
SERVE_CLIENT = """
import json, os, sys, time

import numpy as np
import ray_tpu_torch as rt

rt.init(address="ray_tpu_torch://127.0.0.1:{port}")


@rt.remote(num_gpus=1)
class TinyServe:
    def __init__(self, path):
        import torch
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.serve.llm import LLMServer

        tree = {{}}
        for key, value in np.load(path).items():
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {{}})
            node[leaf] = value
        cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")
        params = params_from_numpy(tree, cfg, "cpu")
        self.server = LLMServer(
            model_config=cfg, params_loader=lambda: params,
            engine_config={{"num_slots": 2, "max_seq_len": 160,
                           "prefill_buckets": (16, 128)}},
            quantize="bf16", device="cpu")

    def serve(self, request):
        return self.server(request)

    def lease(self):
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")


actor = TinyServe.remote({weights!r})
out = [rt.get(actor.serve.remote(r), timeout=120)["tokens"]
       for r in {reqs!r}]
lease = rt.get(actor.lease.remote(), timeout=60)
rt.kill(actor)
rt.shutdown()
print("RESULT " + json.dumps({{
    "tokens": out, "lease": lease,
    "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ray_tpu", "torch"))}}))
"""


def test_thin_client_without_a_card_serves_jax_tokens(server, tmp_path):
    """The slice as a whole: a client process that sees no card
    (``CUDA_VISIBLE_DEVICES=""``) and never imports torch creates a
    ``num_gpus=1`` serving actor through the thin client; its tokens are
    the JAX package's greedy tokens, the server holds no pin of it after
    it exits, and the GPU is back in the cluster."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as J

    jc = J.LlamaConfig.tiny(dtype=jnp.float32)
    jp = J.init_params(jc, jax.random.key(0))
    flat = {}

    def walk(node, prefix=""):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.asarray(value)

    walk(jax.tree_util.tree_map(np.asarray, jp))
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **flat)
    rng = np.random.RandomState(0)
    reqs = [{"prompt": rng.randint(0, 256, p).tolist(), "max_tokens": n}
            for p, n in ((3, 6), (40, 7))]
    script = tmp_path / "serve_client.py"
    script.write_text(SERVE_CLIENT.format(port=server.port, weights=weights,
                                          reqs=reqs))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300,
                          env=_client_env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("RESULT ")]
    res = json.loads(line[len("RESULT "):])
    assert res["lease"] == [[0], "0"]
    assert res["cuda_visible_devices"] == "" and res["modules"] == []
    for r, got in zip(reqs, res["tokens"]):
        want = np.asarray(J.generate(
            jp, jnp.asarray([r["prompt"]], jnp.int32), jc,
            max_new_tokens=r["max_tokens"]))[0].tolist()
        assert got == want
    assert server._refs == {} and server._actors == {}
    assert _wait_for(
        lambda: ray_tpu_torch.available_resources().get("GPU", 0) == 1, 60)
