"""The port's Serve control plane (``ray_tpu_torch.serve``) on the CPU.

The cases of the reference's own ``tests/test_serve.py`` (all but the
HTTP proxy, held in ``tests/test_torch_serve_ingress.py``), each
asserting what it asserts there, run against the port's cluster; then
what the port adds or changes: a replica's share of the card is
``num_gpus`` (two 0.5 replicas on one card, the controller on none),
``num_tpus`` raises, the GCS prefix index (the reference's
``test_cluster_prefix_index_gcs``), a scale decision of
``num_replicas="auto"`` reaching the GCS decision ring, and
``serve_replicas`` read back through the metrics push and
``util.metrics.query``. One cluster for the module, with one fake GPU
and the prefix index's TTL short; every ``get`` has a timeout, so a hang
fails one test.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

INDEX_TTL_S = 0.5


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(
        num_cpus=8, num_gpus=1, object_store_memory=256 * 1024 * 1024,
        _system_config={"serve_prefix_index_ttl_s": INDEX_TTL_S,
                        "serve_autoscale_cooldown_s": 0.0,
                        "serve_autoscale_interval_s": 0.5,
                        "metrics_report_interval_s": 0.5})
    yield info
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def _serve_cleanup(cluster):
    yield
    serve.shutdown()


@serve.deployment
class Doubler:
    def __call__(self, x):
        return 2 * x

    def triple(self, x):
        return 3 * x


def _poll(fn, timeout=60.0, period=0.2):
    deadline = time.monotonic() + timeout
    while True:
        out = fn()
        if out or time.monotonic() > deadline:
            return out
        time.sleep(period)


# -------------------------------------------- the reference's test_serve.py


def test_deploy_and_handle_call():
    handle = serve.run(Doubler.bind(), name="doubler")
    assert handle.remote(21).result(timeout=60) == 42
    assert handle.triple.remote(5).result(timeout=60) == 15


def test_multiple_replicas_share_load():
    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __call__(self, _):
            return os.getpid()

    handle = serve.run(WhoAmI.bind(), name="who")
    pids = {handle.remote(None).result(timeout=60) for _ in range(20)}
    assert len(pids) == 2  # pow-2 routing reaches both replicas


def test_function_deployment():
    @serve.deployment
    def add_one(x):
        return x + 1

    handle = serve.run(add_one.bind(), name="fn")
    assert handle.remote(41).result(timeout=60) == 42


def test_composition_with_inner_handle():
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x * 10

    @serve.deployment
    class Pipeline:
        def __init__(self, pre):
            self._pre = pre  # DeploymentHandle (rehydrated in the replica)

        def __call__(self, x):
            pre = self._pre.remote(x).result(timeout=60)
            return pre + 1

    app = Pipeline.bind(Preprocess.bind())
    handle = serve.run(app, name="pipeline")
    assert handle.remote(4).result(timeout=60) == 41


def test_objectref_args_materialized():
    # The disagg two-hop forwards one replica's result ObjectRef
    # straight into another replica's args (serve/llm/router.py); the
    # worker's task-arg resolution can't see inside the handle_request
    # envelope, so the replica itself must materialize ref args.
    @serve.deployment
    class Echo:
        def __call__(self, x, tag="t"):
            return (type(x).__name__, x, tag)

    handle = serve.run(Echo.bind(), name="echo")
    tname, val, _ = handle.remote(
        ray_tpu_torch.put(123)).result(timeout=60)
    assert (tname, val) == ("int", 123)
    _, _, tag = handle.remote(
        1, tag=ray_tpu_torch.put("hi")).result(timeout=60)
    assert tag == "hi"


def test_redeploy_scales_replicas():
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, _):
            return "ok"

    serve.run(S.bind(), name="scale")
    assert serve.status("scale")[0]["num_replicas"] == 1

    serve.run(S.options(num_replicas=3).bind(), name="scale")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = serve.status("scale")[0]
        if st["live_replicas"] == 3:
            break
        time.sleep(0.5)
    assert serve.status("scale")[0]["live_replicas"] == 3


def test_replica_crash_recovery():
    @serve.deployment(num_replicas=1)
    class Fragile:
        def __call__(self, cmd):
            if cmd == "die":
                os._exit(1)
            return "alive"

    handle = serve.run(Fragile.bind(), name="fragile")
    assert handle.remote("ping").result(timeout=60) == "alive"
    try:
        handle.remote("die").result(timeout=30)
    except Exception:
        pass
    # The controller's reconcile loop replaces the dead replica.
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        try:
            assert handle.remote("ping").result(timeout=30) == "alive"
            break
        except Exception:
            time.sleep(1.0)
    else:
        pytest.fail("replica never recovered")


# ------------------------------------------------------- the card in Serve


def test_half_gpu_replicas_share_the_card_and_the_controller_none():
    """Two num_gpus=0.5 replicas lease id 0 each, under
    CUDA_VISIBLE_DEVICES="0"; the controller leases no GPU, so the card
    is fully taken by the two and free again after the delete."""
    @serve.deployment(num_replicas=2, num_gpus=0.5)
    class Lease:
        def __call__(self, _):
            return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                    ray_tpu_torch.get_gpu_ids())

    handle = serve.run(Lease.bind(), name="lease")
    seen = {}
    for _ in range(20):
        pid, visible, ids = handle.remote(None).result(timeout=60)
        seen[pid] = (visible, ids)
    assert len(seen) == 2
    assert all(v == ("0", [0]) for v in seen.values()), seen
    assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
    serve.delete("lease")
    assert _poll(lambda: ray_tpu_torch.available_resources().get(
        "GPU", 0) == 1)


def test_deployment_refuses_num_tpus_as_the_runtime_does():
    with pytest.raises(ValueError, match="num_gpus") as got:
        serve.deployment(num_tpus=1)
    with pytest.raises(ValueError) as want:
        ray_tpu_torch.remote(num_tpus=1)(lambda: None)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="num_gpus"):
        Doubler.options(num_tpus=1)
    with pytest.raises(TypeError, match="num_cpu"):
        serve.deployment(num_cpu=1)


def test_handles_rebuild_from_their_coordinates():
    """A handle passed into a replica is rebuilt there from (app,
    deployment, model id), without the caller's router."""
    import cloudpickle

    handle = serve.run(Doubler.bind(), name="rebuilt")
    assert handle.remote(1).result(timeout=60) == 2   # has a router now
    back = cloudpickle.loads(cloudpickle.dumps(handle))
    assert (back._app, back._deployment, back._router) == (
        "rebuilt", "Doubler", None)
    assert back.remote(5).result(timeout=60) == 10
    assert serve.get_app_handle("rebuilt").remote(7).result(
        timeout=60) == 14
    with pytest.raises(KeyError):
        serve.get_app_handle("nosuchapp")


# ------------------------------------------------------ the GCS and metrics


def test_cluster_prefix_index_gcs():
    """report_prefix_index / lookup_prefix_index: roundtrip,
    last-write-wins per replica, the serve_prefix_index_max_heads cap,
    and lazy TTL expiry at lookup (the TTL reaches the GCS through
    _system_config)."""
    from ray_tpu_torch._private.config import GlobalConfig
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    assert GlobalConfig.serve_prefix_index_ttl_s == INDEX_TTL_S
    assert w.gcs.call(
        "report_prefix_index", timeout=10, replica="repA",
        heads=[(11, 1), (22, 2)],
        tiers={"block_size": 8, "host_blocks": 3})
    idx = w.gcs.call("lookup_prefix_index", timeout=10)
    rec = idx["repA"]
    assert [(int(h), int(d)) for h, d in rec["heads"]] \
        == [(11, 1), (22, 2)]
    assert rec["tiers"]["block_size"] == 8
    assert rec["age_s"] >= 0.0

    # Last write wins, hottest-first heads capped at the limit.
    cap = int(GlobalConfig.serve_prefix_index_max_heads)
    w.gcs.call("report_prefix_index", timeout=10, replica="repA",
               heads=[(i, i + 1) for i in range(cap + 100)],
               tiers={})
    idx = w.gcs.call("lookup_prefix_index", timeout=10)
    assert len(idx["repA"]["heads"]) == cap
    assert idx["repA"]["tiers"] == {}

    # Publish IS the heartbeat: a silent replica ages out lazily.
    time.sleep(INDEX_TTL_S + 0.2)
    assert "repA" not in w.gcs.call("lookup_prefix_index", timeout=10)


def test_serve_replicas_gauge_reaches_the_metrics_plane():
    """The controller's serve_replicas gauge is pushed by its process's
    metrics flusher and read back through util.metrics.query."""
    from ray_tpu_torch.util import metrics

    @serve.deployment(num_replicas=2)
    class Two:
        def __call__(self, x):
            return x

    handle = serve.run(Two.bind(), name="two")
    assert handle.remote(3).result(timeout=60) == 3

    def reading():
        return metrics.query("serve_replicas",
                             labels={"deployment": "two/Two"}).latest

    assert _poll(lambda: reading() == 2.0, timeout=30), reading()


def test_autoscale_decision_reaches_the_decision_ring():
    """num_replicas="auto": in-flight load above the target scales the
    deployment up, and the decision lands in the GCS decision ring and
    as an AUTOSCALE_UP cluster event, with the reading behind it."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    @serve.deployment(num_replicas="auto", max_ongoing_requests=8,
                      autoscaling_config={
                          "min_replicas": 1, "max_replicas": 2,
                          "target_ongoing_requests": 1,
                          "upscale_delay_s": 0.0,
                          "downscale_delay_s": 600.0})
    class Slow:
        def __call__(self, s):
            time.sleep(s)
            return s

    handle = serve.run(Slow.bind(), name="auto")
    assert serve.status("auto")[0]["num_replicas"] == 1
    pending = [handle.remote(6.0) for _ in range(4)]

    def decisions():
        return [d for d in global_worker().gcs.call(
            "list_ctrl_decisions", controller="serve_autoscaler",
            timeout=10) if d["reading"].get("app") == "auto"]

    got = _poll(decisions, timeout=60)
    assert got, "no scale decision reached the ring"
    d = got[0]
    assert d["action"] == "scale_up"
    assert (d["reading"]["from"], d["reading"]["to"]) == (1, 2)
    assert d["reading"]["inflight"] >= 2
    assert _poll(lambda: serve.status("auto")[0]["live_replicas"] == 2)
    events = state.list_cluster_events(event_type="AUTOSCALE_UP")
    assert any(e.get("deployment") == "Slow" for e in events), events
    assert [r.result(timeout=60) for r in pending] == [6.0] * 4
