"""Compiled DAGs over shared-memory channels on the port
(``ray_tpu_torch.experimental.channel``, ``ray_tpu_torch.dag``): every
case of the reference's own ``tests/test_dag.py``, asserting what it
asserts there, on the port's cluster; the channel held to the JAX
package's byte for byte (one package creates, the other attaches by
name, both ways); tensors crossing a channel as the object store
carries them; and the slice as a whole: a tokenize -> serve -> detokenize
pipeline around a ``num_gpus=1`` actor (the GPU faked, the server on the
CPU) that gives the JAX package's greedy tokens, interpreted and
compiled. One cluster for the module; every wait has a timeout.
"""

import pickle
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.experimental import Channel, ChannelClosedError
from ray_tpu_torch.experimental.channel import ChannelFullError


# ---------------------------------------------------------------- channels
class TestChannel:
    def test_spsc_roundtrip(self):
        ch = Channel(create=True, buffer_size=1 << 16)
        try:
            ch.write({"x": 1, "arr": list(range(100))})
            assert ch.read(timeout=5)["x"] == 1
            ch.write(2)
            assert ch.read(timeout=5) == 2
        finally:
            ch.release()

    def test_backpressure_blocks_writer(self):
        ch = Channel(create=True, buffer_size=1 << 12)
        try:
            ch.write("a")
            with pytest.raises(TimeoutError):
                ch.write("b", timeout=0.2)   # unread value -> blocked
            assert ch.read(timeout=5) == "a"
            ch.write("b", timeout=5)         # reader consumed -> unblocked
            assert ch.read(timeout=5) == "b"
        finally:
            ch.release()

    def test_too_large_value(self):
        ch = Channel(create=True, buffer_size=128)
        try:
            with pytest.raises(ChannelFullError):
                ch.write(b"x" * 1024)
        finally:
            ch.release()

    def test_close_wakes_blocked_reader(self):
        ch = Channel(create=True, buffer_size=1 << 12)
        errs = []
        reading = threading.Event()

        def reader():
            reading.set()
            try:
                ch.read(timeout=10)
            except Exception as e:   # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=reader)
        t.start()
        assert reading.wait(5)
        ch.close()
        t.join(5)
        assert not t.is_alive()
        assert isinstance(errs[0], ChannelClosedError)
        ch.release()

    def test_attach_by_name(self):
        owner = Channel(create=True, buffer_size=1 << 12)
        try:
            peer = Channel(owner.name)
            owner.write(41)
            assert peer.read(timeout=5) == 41
        finally:
            owner.release()


# ------------------------------------------- the JAX package's channel
def _jax_channel():
    pytest.importorskip("jax")
    from ray_tpu.experimental import channel as jchannel

    return jchannel


_VALUES = [41, "s", {"x": 1, "arr": list(range(100))}, (1.5, None, b"b"),
           np.arange(6, dtype=np.int32).reshape(2, 3)]


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_channel_crosses_packages_by_name(creator):
    """One package creates the slot, the other attaches by name; values
    go both ways (one side writes, the other reads, then the roles
    swap), and the header counters step as one protocol."""
    jchannel = _jax_channel()
    make, attach = ((lambda: Channel(create=True, buffer_size=1 << 14),
                     jchannel.Channel) if creator == "port" else
                    (lambda: jchannel.Channel(create=True,
                                              buffer_size=1 << 14),
                     Channel))
    owner = make()
    try:
        peer = attach(owner.name)
        for i, v in enumerate(_VALUES):
            writer, reader = (owner, peer) if i % 2 == 0 else (peer, owner)
            writer.write(v, timeout=5)
            assert _same(reader.read(timeout=5), v)
        buf = owner._shm.buf
        n = len(_VALUES)
        assert [int.from_bytes(buf[o:o + 8], "little")
                for o in (0, 8)] == [n, n]
        peer.close()
        with pytest.raises((ChannelClosedError, jchannel.ChannelClosedError)):
            owner.read(timeout=5)
    finally:
        owner.release()


@pytest.mark.parametrize("value", _VALUES, ids=lambda v: type(v).__name__)
def test_channel_bytes_equal_the_jax_package(value):
    """The same value written into a slot of each package leaves equal
    header and payload bytes (header layout, pickle protocol 5)."""
    jchannel = _jax_channel()
    ours = Channel(create=True, buffer_size=1 << 14)
    theirs = jchannel.Channel(create=True, buffer_size=1 << 14)
    try:
        ours.write(value, timeout=5)
        theirs.write(value, timeout=5)
        n = int.from_bytes(ours._shm.buf[16:24], "little")
        assert n == len(pickle.dumps(value, protocol=5))
        assert bytes(ours._shm.buf[:32 + n]) == \
            bytes(theirs._shm.buf[:32 + n])
        assert Channel.serialize(value) == jchannel.Channel.serialize(value)
    finally:
        ours.release()
        theirs.release()


def test_tensor_crosses_as_the_object_store_carries_it():
    """A tensor is reduced by the object store's reducer, so a CPU tensor
    reads back equal (dtype, shape, strides of a view), and one that was
    on the card is rebuilt on the reader's CUDA device, or raises in a
    reader without one, never landing on the CPU."""
    torch = pytest.importorskip("torch")
    from ray_tpu_torch._private.serialization import _rebuild_tensor

    ch = Channel(create=True, buffer_size=1 << 16)
    try:
        t = torch.arange(24, dtype=torch.bfloat16).reshape(4, 6)[:, 1:5]
        ch.write({"t": t, "n": 3}, timeout=5)
        got = ch.read(timeout=5)
        assert got["n"] == 3 and got["t"].dtype == torch.bfloat16
        assert torch.equal(got["t"], t)
        assert b"_rebuild_tensor" in Channel.serialize(t)

        class OnCard:          # what _reduce_tensor makes of a CUDA tensor
            def __reduce__(self):
                raw = torch.arange(4, dtype=torch.float32).numpy()
                return _rebuild_tensor, (
                    pickle.PickleBuffer(raw.view(np.uint8)),
                    "torch.float32", (4,), (1,), "cuda", False)

        ch.write(OnCard(), timeout=5)
        if torch.cuda.is_available():
            assert ch.read(timeout=5).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ch.read(timeout=5)
    finally:
        ch.release()


# -------------------------------------------------------------------- DAGs
@pytest.fixture(scope="module")
def dag_cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=1,
                              object_store_memory=128 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _worker_cls():
    @ray_tpu_torch.remote
    class Worker:
        def __init__(self, scale):
            self.scale = scale
            self.calls = 0

        def mul(self, x):
            self.calls += 1
            return x * self.scale

        def add(self, x, y):
            return x + y

        def boom(self, x):
            raise ValueError(f"boom-{x}")

        def num_calls(self):
            return self.calls

    return Worker


def _kill(*actors):
    for a in actors:
        ray_tpu_torch.kill(a)


def test_interpreted_execute(dag_cluster):
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    Worker = _worker_cls()
    a, b = Worker.remote(2), Worker.remote(10)

    @ray_tpu_torch.remote
    def plus_one(x):
        return x + 1

    with InputNode() as inp:
        dag = b.mul.bind(plus_one.bind(a.mul.bind(inp)))
    assert ray_tpu_torch.get(dag.execute(3), timeout=60) == 70  # (3*2+1)*10

    with InputNode() as inp:
        multi = MultiOutputNode([a.mul.bind(inp), b.mul.bind(inp)])
    refs = multi.execute(4)
    assert ray_tpu_torch.get(refs, timeout=60) == [8, 40]
    _kill(a, b)


def test_compiled_chain_and_reuse(dag_cluster):
    from ray_tpu_torch.dag import InputNode

    Worker = _worker_cls()
    a, b = Worker.remote(2), Worker.remote(10)
    with InputNode() as inp:
        dag = b.mul.bind(a.mul.bind(inp))
    compiled = dag.experimental_compile()
    try:
        for i in range(20):
            assert compiled.execute(i).get(timeout=30) == i * 20
    finally:
        stages = compiled.teardown()
    # Each stage loop ran every execution; teardown returns what each
    # loop returned, and a second teardown the same.
    assert stages == [{"iterations": 20}, {"iterations": 20}]
    assert compiled.teardown() == stages
    # Actors are released and usable again after teardown.
    assert ray_tpu_torch.get(a.mul.remote(5), timeout=60) == 10
    # The stage loop ran all 20 executions in-place on the actor.
    assert ray_tpu_torch.get(a.num_calls.remote(), timeout=60) >= 20
    _kill(a, b)


def test_compiled_multi_output_and_input_key(dag_cluster):
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    Worker = _worker_cls()
    a, c = Worker.remote(2), Worker.remote(3)
    with InputNode() as inp:
        dag = MultiOutputNode([a.mul.bind(inp["x"]), c.mul.bind(inp["y"])])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute({"x": 4, "y": 5}).get(timeout=30) == [8, 15]
        assert compiled.execute({"x": 0, "y": 1}).get(timeout=30) == [0, 3]
    finally:
        compiled.teardown()
        _kill(a, c)


def test_compiled_stage_error_propagates(dag_cluster):
    from ray_tpu_torch.dag import InputNode

    Worker = _worker_cls()
    a, b = Worker.remote(2), Worker.remote(10)
    with InputNode() as inp:
        dag = b.mul.bind(a.boom.bind(inp))
    compiled = dag.experimental_compile()
    try:
        with pytest.raises(ValueError, match="boom-7"):
            compiled.execute(7).get(timeout=30)
        # The pipeline survives the error and keeps serving.
        with pytest.raises(ValueError, match="boom-8"):
            compiled.execute(8).get(timeout=30)
    finally:
        compiled.teardown()
        _kill(a, b)


def test_compile_rejects_function_nodes_and_actor_reuse(dag_cluster):
    from ray_tpu_torch.dag import InputNode

    Worker = _worker_cls()
    a = Worker.remote(2)

    @ray_tpu_torch.remote
    def f(x):
        return x

    with InputNode() as inp:
        bad = a.mul.bind(f.bind(inp))
    with pytest.raises(TypeError, match="actor-method"):
        bad.experimental_compile()

    with InputNode() as inp:
        twice = a.mul.bind(a.mul.bind(inp))
    with pytest.raises(ValueError, match="one method per actor"):
        twice.experimental_compile()
    _kill(a)


def test_compiled_fifo_and_in_flight_cap(dag_cluster):
    from ray_tpu_torch.dag import InputNode

    Worker = _worker_cls()
    a = Worker.remote(2)
    with InputNode() as inp:
        dag = a.mul.bind(inp)
    compiled = dag.experimental_compile()
    try:
        r1 = compiled.execute(1)
        r2 = compiled.execute(2)
        with pytest.raises(RuntimeError, match="in flight"):
            compiled.execute(3)          # cap = 2
        with pytest.raises(RuntimeError, match="FIFO"):
            r2.get(timeout=10)           # out-of-order consumption
        assert r1.get(timeout=10) == 2
        assert r2.get(timeout=10) == 4
        assert compiled.execute(3).get(timeout=10) == 6
    finally:
        compiled.teardown()
        _kill(a)


def test_compiled_missing_method_surfaces(dag_cluster):
    from ray_tpu_torch.dag import InputNode

    Worker = _worker_cls()
    a = Worker.remote(2)
    with InputNode() as inp:
        dag = a.no_such_method.bind(inp)
    compiled = dag.experimental_compile()
    try:
        with pytest.raises(AttributeError, match="no_such_method"):
            compiled.execute(1).get(timeout=15)
    finally:
        compiled.teardown()
        _kill(a)


def test_compiled_oversized_result_fails_that_execution_only(dag_cluster):
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Blob:
        def make(self, n):
            return b"x" * n

    a = Blob.remote()
    with InputNode() as inp:
        dag = a.make.bind(inp)
    compiled = dag.experimental_compile(_buffer_size_bytes=1 << 16)
    try:
        with pytest.raises(ChannelFullError):
            compiled.execute(1 << 20).get(timeout=15)
        # Pipeline still alive afterwards.
        assert compiled.execute(8).get(timeout=15) == b"x" * 8
    finally:
        compiled.teardown()
        _kill(a)


def test_compiled_faster_than_task_path(dag_cluster):
    """The whole point: channel hops beat per-call task RPCs."""
    from ray_tpu_torch.dag import InputNode

    Worker = _worker_cls()
    a, b = Worker.remote(2), Worker.remote(10)
    with InputNode() as inp:
        dag = b.mul.bind(a.mul.bind(inp))
    compiled = dag.experimental_compile()
    compiled.execute(0).get(timeout=30)   # warm
    t0 = time.perf_counter()
    n = 100
    for i in range(n):
        compiled.execute(i).get(timeout=30)
    compiled_dt = (time.perf_counter() - t0) / n
    compiled.teardown()

    t0 = time.perf_counter()
    m = 30
    for i in range(m):
        ray_tpu_torch.get(
            b.mul.remote(ray_tpu_torch.get(a.mul.remote(i), timeout=30)),
            timeout=30)
    task_dt = (time.perf_counter() - t0) / m
    _kill(a, b)
    assert compiled_dt < task_dt, (compiled_dt, task_dt)


def test_bind_builds_nodes_and_class_bind_stays_refused(dag_cluster):
    """``fn.bind`` and ``actor.method.bind`` build the reference's node
    types; binding an actor class stays refused as in the reference."""
    from ray_tpu_torch.dag import ClassMethodNode, FunctionNode, InputNode

    Worker = _worker_cls()
    a = Worker.remote(2)

    @ray_tpu_torch.remote
    def f(x):
        return x

    inp = InputNode()
    assert isinstance(f.bind(inp), FunctionNode)
    node = a.mul.bind(inp)
    assert isinstance(node, ClassMethodNode)
    assert node._actor_id == a._actor_id
    with pytest.raises(NotImplementedError, match="actor.method.bind"):
        Worker.bind(2)
    _kill(a)


# ------------------------------------------------ the slice, on the CPU
def _pipeline_classes():
    @ray_tpu_torch.remote
    class Tok:
        def encode(self, request):
            if "text" not in request:
                raise ValueError("a request without text")
            return {"prompt": [ord(c) % 256 for c in request["text"]],
                    "max_tokens": request["max_tokens"]}

    @ray_tpu_torch.remote(num_gpus=1)
    class Serve:
        def __init__(self, tree):
            import torch

            from ray_tpu_torch.models.convert import params_from_numpy
            from ray_tpu_torch.models.llama import LlamaConfig
            from ray_tpu_torch.serve.llm import LLMServer

            cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")
            params = params_from_numpy(tree, cfg, "cpu")
            self.server = LLMServer(
                model_config=cfg, params_loader=lambda: params,
                engine_config={"num_slots": 2, "max_seq_len": 160,
                               "prefill_buckets": (16, 128)},
                quantize="bf16", device="cpu")

        def generate(self, request):
            return self.server(request)

        def lease(self):
            return ray_tpu_torch.get_gpu_ids()

    @ray_tpu_torch.remote
    class Detok:
        def decode(self, out):
            return {"tokens": out["tokens"],
                    "text": "".join(chr(32 + t % 95) for t in out["tokens"])}

    return Tok, Serve, Detok


def _jax_tiny():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as J

    jc = J.LlamaConfig.tiny(dtype=jnp.float32)
    jp = J.init_params(jc, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)

    def generate(prompt, n):
        return np.asarray(J.generate(jp, jnp.asarray([prompt], jnp.int32),
                                     jc, max_new_tokens=n))[0].tolist()

    return tree, generate


def test_compiled_pipeline_around_a_gpu_actor_gives_jax_tokens(dag_cluster):
    """The slice as a whole: tokenize -> serve on a ``num_gpus=1`` actor
    -> detokenize, interpreted and compiled, gives the JAX package's
    greedy tokens; a stage that raises comes back as its error and the
    next execution succeeds; teardown counts every execution; the GPU
    actor answers ordinary calls afterwards."""
    from ray_tpu_torch.dag import InputNode

    tree, generate = _jax_tiny()
    Tok, Serve, Detok = _pipeline_classes()
    tok, srv, det = Tok.remote(), Serve.remote(tree), Detok.remote()
    reqs = [{"text": "hello", "max_tokens": 6},
            {"text": "a longer prompt past sixteen tokens", "max_tokens": 4}]
    want = [generate([ord(c) % 256 for c in r["text"]], r["max_tokens"])
            for r in reqs]
    try:
        with InputNode() as inp:
            dag = det.decode.bind(srv.generate.bind(tok.encode.bind(inp)))
        interpreted = [ray_tpu_torch.get(dag.execute(r), timeout=120)
                       for r in reqs]
        assert [o["tokens"] for o in interpreted] == want
        compiled = dag.experimental_compile()
        try:
            got = [compiled.execute(r).get(timeout=120) for r in reqs]
            with pytest.raises(ValueError, match="without text"):
                compiled.execute({"max_tokens": 1}).get(timeout=60)
            again = compiled.execute(reqs[0]).get(timeout=120)
        finally:
            stages = compiled.teardown()
        assert got == interpreted and again == interpreted[0]
        assert stages == [{"iterations": len(reqs) + 2}] * 3
        assert ray_tpu_torch.get(srv.lease.remote(), timeout=60) == [0]
    finally:
        _kill(tok, srv, det)
