"""The port's core runtime (``ray_tpu_torch``: tasks, actors, objects,
the GCS and the raylet) on the CPU.

The cases of the reference's own ``tests/test_basic.py`` and
``tests/test_actors.py``, each asserting what it asserts there, run
against the port's cluster; then the slice as a whole: an actor of the
port's cluster hosts the port's ``LLMServer`` (``LlamaConfig.tiny()``,
f32, weights from the JAX package's ``init_params``) and its greedy tokens,
dense and paged, equal the JAX package's ``generate``; and a reference
cluster started beside the port's works, in a session directory of its
own. One cluster for the module; every ``get`` and ``wait`` has a
timeout, so a hang fails one test.
"""

import os
import time
import uuid

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                              object_store_memory=256 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def echo(x):
    return x


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value

    def fail(self):
        raise RuntimeError("actor method failed")

    def get_pid(self):
        return os.getpid()

    def crash(self):
        os._exit(1)


# --------------------------------------------------------------- test_basic

class TestPutGet:
    def test_small_roundtrip(self, cluster):
        ref = ray_tpu_torch.put({"k": 1})
        assert ray_tpu_torch.get(ref, timeout=30) == {"k": 1}

    def test_large_object_via_plasma(self, cluster):
        arr = np.random.rand(512, 1024)  # 4 MiB > inline threshold
        ref = ray_tpu_torch.put(arr)
        out = ray_tpu_torch.get(ref, timeout=30)
        np.testing.assert_array_equal(out, arr)

    def test_get_list(self, cluster):
        refs = [ray_tpu_torch.put(i) for i in range(5)]
        assert ray_tpu_torch.get(refs, timeout=30) == list(range(5))

    def test_put_of_ref_rejected(self, cluster):
        with pytest.raises(TypeError):
            ray_tpu_torch.put(ray_tpu_torch.put(1))


class TestTasks:
    def test_basic_task(self, cluster):
        assert ray_tpu_torch.get(add.remote(1, 2), timeout=60) == 3

    def test_kwargs(self, cluster):
        assert ray_tpu_torch.get(add.remote(1, b=41), timeout=60) == 42

    def test_ref_arg_resolution(self, cluster):
        a = ray_tpu_torch.put(10)
        assert ray_tpu_torch.get(add.remote(a, 5), timeout=60) == 15

    def test_chained_tasks(self, cluster):
        r = add.remote(1, 1)
        for _ in range(5):
            r = add.remote(r, 1)
        assert ray_tpu_torch.get(r, timeout=60) == 7

    def test_large_arg_and_return(self, cluster):
        arr = np.ones((256, 1024))

        @ray_tpu_torch.remote
        def double(x):
            return x * 2

        out = ray_tpu_torch.get(double.remote(arr), timeout=60)
        np.testing.assert_array_equal(out, arr * 2)

    def test_num_returns(self, cluster):
        @ray_tpu_torch.remote(num_returns=3)
        def three():
            return 1, 2, 3

        r1, r2, r3 = three.remote()
        assert ray_tpu_torch.get([r1, r2, r3], timeout=60) == [1, 2, 3]

    def test_num_returns_zero(self, cluster):
        @ray_tpu_torch.remote(num_returns=0)
        def fire_and_forget():
            return None

        assert fire_and_forget.remote() is None

    def test_options_override(self, cluster):
        assert ray_tpu_torch.get(echo.options(name="custom").remote(7),
                                 timeout=60) == 7

    def test_parallel_tasks(self, cluster):
        @ray_tpu_torch.remote
        def slow(i):
            time.sleep(0.2)
            return i

        # Warm the worker pool first; then parallelism must be real.
        ray_tpu_torch.get([slow.remote(i) for i in range(8)], timeout=60)
        start = time.monotonic()
        out = ray_tpu_torch.get([slow.remote(i) for i in range(8)],
                                timeout=60)
        elapsed = time.monotonic() - start
        assert out == list(range(8))
        # 8 tasks x 0.2s on a warm 8-CPU pool must overlap substantially.
        assert elapsed < 1.2

    def test_nested_tasks(self, cluster):
        @ray_tpu_torch.remote
        def outer(n):
            return ray_tpu_torch.get(add.remote(n, 1), timeout=60)

        assert ray_tpu_torch.get(outer.remote(1), timeout=60) == 2

    def test_invalid_option_rejected(self, cluster):
        with pytest.raises(ValueError):
            @ray_tpu_torch.remote(bogus_option=1)
            def f():
                pass

    def test_direct_call_rejected(self, cluster):
        with pytest.raises(TypeError):
            echo(1)


class TestErrors:
    @pytest.mark.parametrize("raised, caught, match", [
        (ValueError("boom!"), ValueError, "boom!"),
        (KeyError("k"), exc.RayTaskError, None),
    ], ids=["task_error_propagates", "error_is_ray_task_error_too"])
    def test_task_error(self, cluster, raised, caught, match):
        @ray_tpu_torch.remote
        def boom():
            raise raised

        with pytest.raises(caught, match=match):
            ray_tpu_torch.get(boom.remote(), timeout=30)

    def test_dependent_task_poisoned(self, cluster):
        @ray_tpu_torch.remote
        def boom():
            raise ValueError("poisoned upstream")

        bad = boom.remote()
        with pytest.raises(ValueError, match="poisoned upstream"):
            ray_tpu_torch.get(add.remote(bad, 1), timeout=30)

    def test_get_timeout(self, cluster):
        @ray_tpu_torch.remote
        def sleepy():
            time.sleep(60)

        ref = sleepy.remote()
        with pytest.raises(exc.GetTimeoutError):
            ray_tpu_torch.get(ref, timeout=0.2)
        ray_tpu_torch.cancel(ref, force=True)

    def test_retry_exceptions(self, cluster):
        @ray_tpu_torch.remote(max_retries=3, retry_exceptions=True)
        def flaky(marker):
            import tempfile

            path = f"{tempfile.gettempdir()}/flaky-{marker}"
            if not os.path.exists(path):
                open(path, "w").close()
                raise RuntimeError("first attempt fails")
            os.unlink(path)
            return "recovered"

        assert ray_tpu_torch.get(flaky.remote(uuid.uuid4().hex),
                                 timeout=60) == "recovered"


class TestWait:
    def test_wait_basic(self, cluster):
        @ray_tpu_torch.remote
        def slow(t):
            time.sleep(t)
            return t

        fast = slow.remote(0.05)
        slow_ref = slow.remote(5)
        ready, not_ready = ray_tpu_torch.wait([fast, slow_ref],
                                              num_returns=1, timeout=10)
        assert ready == [fast]
        assert not_ready == [slow_ref]
        ray_tpu_torch.cancel(slow_ref, force=True)

    def test_wait_timeout(self, cluster):
        @ray_tpu_torch.remote
        def sleepy():
            time.sleep(30)

        ref = sleepy.remote()
        ready, not_ready = ray_tpu_torch.wait([ref], num_returns=1,
                                              timeout=0.2)
        assert ready == []
        assert not_ready == [ref]
        ray_tpu_torch.cancel(ref, force=True)

    def test_wait_duplicate_rejected(self, cluster):
        ref = ray_tpu_torch.put(1)
        with pytest.raises(ValueError):
            ray_tpu_torch.wait([ref, ref], timeout=10)


class TestRuntimeContext:
    def test_context_in_task(self, cluster):
        @ray_tpu_torch.remote
        def ctx_info():
            ctx = ray_tpu_torch.get_runtime_context()
            return ctx.get_job_id(), ctx.get_node_id(), ctx.get_task_id()

        job_id, node_id, task_id = ray_tpu_torch.get(ctx_info.remote(),
                                                     timeout=30)
        assert ray_tpu_torch.get_runtime_context().get_job_id() == job_id
        assert task_id is not None

    def test_cluster_resources(self, cluster):
        res = ray_tpu_torch.cluster_resources()
        assert res.get("CPU", 0) >= 8
        assert len(ray_tpu_torch.nodes()) == 1


# -------------------------------------------------------------- test_actors

class TestActorBasics:
    def test_create_and_call(self, cluster):
        c = Counter.remote()
        assert ray_tpu_torch.get(c.increment.remote(), timeout=60) == 1
        assert ray_tpu_torch.get(c.increment.remote(5), timeout=30) == 6

    def test_init_args(self, cluster):
        c = Counter.remote(start=100)
        assert ray_tpu_torch.get(c.get.remote(), timeout=60) == 100

    def test_ordering(self, cluster):
        c = Counter.remote()
        refs = [c.increment.remote() for _ in range(50)]
        assert ray_tpu_torch.get(refs, timeout=60) == list(range(1, 51))

    def test_remote_many_batched_creation(self, cluster):
        # One register_actors GCS RPC admits the whole batch; every
        # handle is independently callable with its own state.
        actors = Counter.options(num_cpus=0).remote_many(4, start=10)
        assert len(actors) == 4
        assert len({a._actor_id for a in actors}) == 4
        vals = ray_tpu_torch.get([a.increment.remote() for a in actors],
                                 timeout=60)
        assert vals == [11, 11, 11, 11]
        with pytest.raises(ValueError, match="named"):
            Counter.options(name="dup").remote_many(2)

    def test_method_error(self, cluster):
        c = Counter.remote()
        with pytest.raises(RuntimeError, match="actor method failed"):
            ray_tpu_torch.get(c.fail.remote(), timeout=60)
        # Actor stays alive after an app-level method error.
        assert ray_tpu_torch.get(c.increment.remote(), timeout=30) == 1

    def test_init_error_marks_dead(self, cluster):
        @ray_tpu_torch.remote
        class Broken:
            def __init__(self):
                raise ValueError("bad init")

            def f(self):
                return 1

        b = Broken.remote()
        with pytest.raises((exc.ActorDiedError, exc.RayTpuError)):
            ray_tpu_torch.get(b.f.remote(), timeout=60)

    def test_handle_passing(self, cluster):
        c = Counter.remote()
        ray_tpu_torch.get(c.increment.remote(), timeout=60)

        @ray_tpu_torch.remote
        def bump(counter):
            return ray_tpu_torch.get(counter.increment.remote(), timeout=60)

        assert ray_tpu_torch.get(bump.remote(c), timeout=60) == 2

    def test_two_actors_isolated(self, cluster):
        a, b = Counter.remote(), Counter.remote()
        ray_tpu_torch.get(a.increment.remote(), timeout=60)
        assert ray_tpu_torch.get(b.get.remote(), timeout=60) == 0


class TestNamedActors:
    def test_named_get(self, cluster):
        original = Counter.options(name="shared-counter").remote()
        handle = ray_tpu_torch.get_actor("shared-counter")
        assert ray_tpu_torch.get(handle.increment.remote(), timeout=60) == 1
        del original

    def test_dropping_all_handles_kills_actor(self, cluster):
        """Non-detached actors are GC'd when the last handle goes away
        (reference semantics), releasing their worker + resources."""
        import gc

        from ray_tpu_torch._private.worker import global_worker

        a = Counter.remote()
        ray_tpu_torch.get(a.get.remote(), timeout=60)
        actor_id = a._actor_id
        del a
        gc.collect()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            info = global_worker().gcs.call("get_actor_info",
                                            actor_id=actor_id, timeout=10)
            if info["state"] == "DEAD":
                return
            time.sleep(0.1)
        raise AssertionError("actor was not GC'd after handle drop")

    def test_name_collision_rejected(self, cluster):
        keep = Counter.options(name="dup").remote()
        time.sleep(0.2)
        with pytest.raises(ValueError):
            Counter.options(name="dup").remote()
        del keep

    def test_get_if_exists(self, cluster):
        a = Counter.options(name="gie").remote()
        ray_tpu_torch.get(a.increment.remote(), timeout=60)
        b = Counter.options(name="gie", get_if_exists=True).remote()
        assert ray_tpu_torch.get(b.get.remote(), timeout=30) == 1

    def test_unknown_name(self, cluster):
        with pytest.raises(ValueError):
            ray_tpu_torch.get_actor("never-created")


class TestAsyncActors:
    def test_async_methods_overlap(self, cluster):
        @ray_tpu_torch.remote(max_concurrency=4)
        class AsyncActor:
            async def slow(self, t):
                import asyncio

                await asyncio.sleep(t)
                return t

        a = AsyncActor.remote()
        # Warm up (actor creation).
        ray_tpu_torch.get(a.slow.remote(0.01), timeout=60)
        start = time.monotonic()
        out = ray_tpu_torch.get([a.slow.remote(0.3) for _ in range(4)],
                                timeout=30)
        elapsed = time.monotonic() - start
        assert out == [0.3] * 4
        assert elapsed < 1.0  # 4 x 0.3s overlapped, not 1.2s serial

    def test_signal_pattern(self, cluster):
        """Wait + send on the same actor from one caller must not deadlock
        (requires in-order start w/ concurrent execution)."""

        @ray_tpu_torch.remote(max_concurrency=2)
        class SignalActor:
            def __init__(self):
                import asyncio

                self.event = asyncio.Event()

            async def wait(self):
                await self.event.wait()
                return "signalled"

            async def send(self):
                self.event.set()
                return "sent"

        s = SignalActor.remote()
        waiter = s.wait.remote()
        time.sleep(0.1)
        sender = s.send.remote()
        assert ray_tpu_torch.get(waiter, timeout=60) == "signalled"
        assert ray_tpu_torch.get(sender, timeout=10) == "sent"


class TestActorReplies:
    def test_quick_call_is_not_held_behind_a_long_one(self, cluster):
        """Each call's reply is its own: a quick call sent right after a
        long one from the same caller returns while the long one runs
        (calls sent in one frame were answered when all of them ended,
        so a serve long poll held every call framed with it)."""

        @ray_tpu_torch.remote(max_concurrency=2)
        class Mixed:
            def long(self, t):
                import time as _time

                _time.sleep(t)
                return "long"

            def quick(self):
                return "quick"

        m = Mixed.remote()
        ray_tpu_torch.get(m.quick.remote(), timeout=60)
        slow, fast = m.long.remote(2.5), m.quick.remote()
        t0 = time.monotonic()
        assert ray_tpu_torch.get(fast, timeout=60) == "quick"
        assert time.monotonic() - t0 < 1.5
        assert ray_tpu_torch.get(slow, timeout=60) == "long"


class TestActorLifecycle:
    def test_kill(self, cluster):
        c = Counter.remote()
        ray_tpu_torch.get(c.get.remote(), timeout=60)
        ray_tpu_torch.kill(c)
        with pytest.raises((exc.ActorDiedError, exc.ActorUnavailableError)):
            ray_tpu_torch.get(c.get.remote(), timeout=60)

    def test_restart_on_crash(self, cluster):
        # max_task_retries stays 0 so the crashing call itself is NOT
        # retried (a retried crash would burn the restart budget every
        # attempt).
        c = Counter.options(max_restarts=1).remote()
        pid1 = ray_tpu_torch.get(c.get_pid.remote(), timeout=60)
        try:
            ray_tpu_torch.get(c.crash.remote(), timeout=30)
        except exc.RayTpuError:
            pass
        # Restarted actor serves calls from a fresh process/state.
        deadline = time.monotonic() + 120
        pid2 = None
        while time.monotonic() < deadline:
            try:
                pid2 = ray_tpu_torch.get(c.get_pid.remote(), timeout=30)
                break
            except exc.RayTpuError:
                time.sleep(0.3)
        assert pid2 is not None and pid2 != pid1
        assert ray_tpu_torch.get(c.get.remote(), timeout=30) == 0

    def test_no_restart_without_budget(self, cluster):
        c = Counter.remote()  # max_restarts=0
        ray_tpu_torch.get(c.get.remote(), timeout=60)
        try:
            ray_tpu_torch.get(c.crash.remote(), timeout=30)
        except exc.RayTpuError:
            pass
        with pytest.raises((exc.ActorDiedError, exc.ActorUnavailableError)):
            ray_tpu_torch.get(c.get.remote(), timeout=60)


# ------------------------------------------------------- the slice, on CPU

@ray_tpu_torch.remote(num_gpus=0, max_concurrency=4)
class TinyServer:
    """The port's ``LLMServer`` in an actor of the port's cluster, on the
    CPU, with the JAX package's weights converted to the port's layout."""

    def __init__(self, tree, engine_config):
        import torch

        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.serve.llm import LLMServer

        cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="flash")
        params = params_from_numpy(tree, cfg, "cpu")
        self.server = LLMServer(model_config=cfg, engine_config=engine_config,
                                params_loader=lambda: params,
                                quantize="bf16", device="cpu")

    def serve(self, request):
        return self.server(request)

    def modules(self):
        import sys

        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ray_tpu"))

    def shutdown(self):
        self.server.shutdown()


_ENGINES = {
    "dense": {"num_slots": 2, "max_seq_len": 160, "prefill_buckets": (16, 128)},
    "paged": {"num_slots": 2, "max_seq_len": 160, "prefill_buckets": (16, 128),
              "kv_layout": "paged", "kv_block_size": 16},
}


@pytest.mark.parametrize("layout", sorted(_ENGINES))
def test_actor_served_tokens_equal_jax_generate(cluster, layout):
    """4 requests through an actor-hosted port server give the JAX
    package's greedy tokens on the same weights and prompts (exact)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as J

    jc = J.LlamaConfig.tiny(dtype=jnp.float32)
    jp = J.init_params(jc, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 256, p).tolist(), n)
            for p, n in ((3, 6), (20, 8), (16, 4), (40, 7))]
    server = TinyServer.remote(tree, _ENGINES[layout])
    try:
        got = ray_tpu_torch.get(
            [server.serve.remote({"prompt": p, "max_tokens": n})
             for p, n in reqs], timeout=120)
        assert ray_tpu_torch.get(server.modules.remote(), timeout=30) == []
    finally:
        ray_tpu_torch.get(server.shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(server)
    for (p, n), out in zip(reqs, got):
        want = np.asarray(J.generate(jp, jnp.asarray([p], jnp.int32), jc,
                                     max_new_tokens=n))[0].tolist()
        assert out["tokens"] == want, (layout, len(p), n)


def test_reference_and_port_clusters_coexist(cluster):
    """A reference cluster started in the same process, after the port's,
    works beside it; each keeps its sessions in its own directory."""
    import ray_tpu

    assert not ray_tpu.is_initialized()
    ref_info = ray_tpu.init(num_cpus=2, num_tpus=0,
                            object_store_memory=128 * 1024 * 1024)
    try:
        @ray_tpu.remote
        def ref_square(x):
            return x * x

        assert ray_tpu.get(ref_square.remote(7), timeout=60) == 49
        assert ray_tpu_torch.get(add.remote(20, 22), timeout=60) == 42
        port_dir, ref_dir = cluster["session_dir"], ref_info["session_dir"]
        assert os.path.dirname(port_dir) != os.path.dirname(ref_dir)
        assert os.path.basename(os.path.dirname(port_dir)) == "ray_tpu_torch"
        assert os.path.basename(os.path.dirname(ref_dir)) == "ray_tpu"
    finally:
        ray_tpu.shutdown()
    assert ray_tpu_torch.get(add.remote(1, 1), timeout=60) == 2
