"""The autoscaler on the port (``ray_tpu_torch.autoscaler``): the
reference's own ``tests/test_autoscaler.py`` cases with a ``num_gpus=1``
demand on a head without a GPU; the scale-up and scale-down decisions of
``StandardAutoscaler`` and ``PodAutoscaler`` held to the JAX package's on
scripted ``get_cluster_load`` sequences; and what only the port does: an
actor's demand (the GCS holds it, no raylet does) reaching the autoscaler,
and a node that leased fractions of its card reading idle again.

The cards are faked (``RAY_TPU_FAKE_GPUS``); every wait has a timeout.
"""

import time
import types

import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators import gpu as G
from ray_tpu_torch.autoscaler import FakeMultiNodeProvider, StandardAutoscaler


@pytest.fixture
def cluster(monkeypatch):
    # The head has no GPU; a node the autoscaler starts fakes its cards.
    monkeypatch.setenv(G.FAKE_GPUS_ENV, "1")
    monkeypatch.setenv(G.FAKE_GPU_TYPE_ENV, "H100")
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024)
    assert "GPU" not in ray_tpu_torch.cluster_resources()
    yield info
    ray_tpu_torch.shutdown()


def _worker():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker()


def _until(fn, timeout, what, period=0.5):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(period)
    raise AssertionError(f"{what} within {timeout} s")


GPU_NODE = {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0,
            "max_workers": 3}


# ----------------------------------------------- the reference's two cases

@pytest.mark.timeout(120)
def test_scales_up_for_infeasible_demand_and_down_when_idle(cluster):
    w = _worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    autoscaler = StandardAutoscaler(
        w.gcs_addr, provider, available_node_types={"gpu.node": GPU_NODE},
        max_workers=3, idle_timeout_s=3.0)
    try:
        # Demand that no current node can satisfy: the head has no GPU.
        @ray_tpu_torch.remote(num_gpus=1)
        def needs_gpu():
            return ray_tpu_torch.get_runtime_context().get_node_id()

        ref = needs_gpu.remote()
        _until(lambda: autoscaler.update()["launched"], 60,
               "the autoscaler never scaled up", period=1.0)

        # The task schedules on the new node once it joins.
        node_id = ray_tpu_torch.get(ref, timeout=90)
        new_pid = provider.non_terminated_nodes()[0]
        assert provider.internal_node_id(new_pid).hex() == node_id

        # Once idle past the timeout, the node scales back down.
        _until(lambda: autoscaler.update()["terminated"], 60,
               "the autoscaler never scaled down", period=1.0)
        assert provider.non_terminated_nodes() == []
    finally:
        provider.shutdown()


@pytest.mark.timeout(120)
def test_min_workers_maintained(cluster):
    w = _worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    autoscaler = StandardAutoscaler(
        w.gcs_addr, provider,
        available_node_types={
            "small": {"resources": {"CPU": 1}, "min_workers": 2},
        },
        max_workers=4, idle_timeout_s=9999)
    try:
        autoscaler.update()
        assert len(provider.non_terminated_nodes()) == 2
        # Killing one gets replaced on the next pass.
        provider.terminate_node(provider.non_terminated_nodes()[0])
        autoscaler.update()
        assert len(provider.non_terminated_nodes()) == 2
        # A node type without GPU takes none of the faked cards.
        assert "GPU" not in ray_tpu_torch.cluster_resources()
    finally:
        provider.shutdown()


# ------------------------------------------------------ decision parity

class _Recorder:
    """A provider that records every call the autoscaler makes. Launch k
    is group ``g<k>`` with hosts ``g<k>h<i>``, whose cluster NodeID is the
    host's name in bytes, so a scripted load can name them."""

    def __init__(self):
        self.calls = []
        self.groups = {}             # group -> (type, [hosts])
        self.launches = 0

    def _launch(self, node_type, gang):
        gid = f"g{self.launches}"
        self.launches += 1
        self.groups[gid] = (node_type, [f"{gid}h{i}" for i in range(gang)])
        return gid

    def create_node(self, node_type, node_config):
        self.calls.append(("create_node", node_type))
        return self.groups[self._launch(node_type, 1)][1][0]

    def create_node_group(self, node_type, node_config, gang_size):
        self.calls.append(("create_node_group", node_type, gang_size))
        return self._launch(node_type, gang_size)

    def terminate_node(self, pid):
        self.calls.append(("terminate_node", pid))
        for gid, (_, hosts) in list(self.groups.items()):
            if pid in hosts or pid == gid:
                del self.groups[gid]

    def terminate_node_group(self, gid):
        self.calls.append(("terminate_node_group", gid))
        self.groups.pop(gid, None)

    def non_terminated_nodes(self):
        return [h for _, hosts in self.groups.values() for h in hosts]

    def node_type_of(self, pid):
        return next((t for t, hosts in self.groups.values() if pid in hosts),
                    None)

    def internal_node_id(self, pid):
        return pid.encode()

    def node_groups(self):
        return list(self.groups)

    def group_nodes(self, gid):
        return list(self.groups.get(gid, (None, []))[1])

    def group_type_of(self, gid):
        return self.groups.get(gid, (None,))[0]

    def shutdown(self):
        pass


def _node(node_id, total, available=None, demands=()):
    return {"node_id": node_id, "total": dict(total),
            "available": dict(total if available is None else available),
            "pending_demands": [dict(d) for d in demands]}


HEAD = {"CPU": 4}
GPU1 = {"CPU": 8, "GPU": 1, "GPU-H100": 1.0}
GANG_HEAD = "GPU-H100-16-head"
TYPES = {
    "gpu": {"resources": GPU1, "min_workers": 0, "max_workers": 3,
            "gang_size": 1},
    "cpu": {"resources": {"CPU": 16}, "min_workers": 0, "max_workers": 2,
            "gang_size": 1},
    "gang": {"resources": {"CPU": 8, "GPU": 8, "GPU-H100": 8.0},
             "head_resources": {GANG_HEAD: 1}, "min_workers": 0,
             "max_workers": 1, "gang_size": 2},
}
IDLE_S = 10.0

# Each scenario: (node types, max_workers, [(clock, load), ...]), one
# step a pass, in order.
SCENARIOS = {
    "infeasible": ({"gpu": TYPES["gpu"], "cpu": TYPES["cpu"]}, 8, [
        (0.0, [_node(b"head", HEAD, demands=[{"GPU": 1}, {"TPU": 1}])]),
        (1.0, [_node(b"head", HEAD, demands=[{"GPU": 1}, {"TPU": 1}])]),
    ]),
    "fits_somewhere": ({"gpu": TYPES["gpu"], "cpu": TYPES["cpu"]}, 8, [
        (0.0, [_node(b"head", HEAD, demands=[{"CPU": 2}])]),
        (1.0, [_node(b"head", HEAD, {"CPU": 2}, demands=[{"CPU": 2}])]),
    ]),
    "covered_by_pending": ({"gpu": TYPES["gpu"]}, 8, [
        (0.0, [_node(b"head", HEAD, demands=[{"GPU": 1}])]),
        (1.0, [_node(b"head", HEAD, demands=[{"GPU": 1}, {"GPU": 1}])]),
        (2.0, [_node(b"head", HEAD, demands=[{"GPU": 1}]),
               _node(b"g0h0", GPU1, {"CPU": 7})]),
    ]),
    "max_workers_cap": ({"gpu": TYPES["gpu"]}, 2, [
        (0.0, [_node(b"head", HEAD, demands=[{"GPU": 1, "CPU": 8}] * 6)]),
        (1.0, [_node(b"head", HEAD, demands=[{"GPU": 1, "CPU": 8}] * 6),
               _node(b"g0h0", GPU1, {}), _node(b"g1h0", GPU1, {})]),
    ]),
    "idle_timeout_vs_min_workers": (
        {"gpu": dict(TYPES["gpu"], min_workers=1), "cpu": TYPES["cpu"]}, 8, [
            (0.0, [_node(b"head", HEAD, demands=[{"CPU": 12}])]),
            (1.0, [_node(b"head", HEAD), _node(b"g0h0", {"CPU": 16}, {}),
                   _node(b"g1h0", GPU1, {"CPU": 7})]),
            (2.0, [_node(b"head", HEAD), _node(b"g0h0", {"CPU": 16}),
                   _node(b"g1h0", GPU1)]),
            (2.0 + IDLE_S / 2, [_node(b"head", HEAD),
                                _node(b"g0h0", {"CPU": 16}),
                                _node(b"g1h0", GPU1)]),
            (3.0 + IDLE_S, [_node(b"head", HEAD), _node(b"g0h0", {"CPU": 16}),
                            _node(b"g1h0", GPU1)]),
            (4.0 + IDLE_S, [_node(b"head", HEAD), _node(b"g1h0", GPU1)]),
        ]),
    "gang": ({"gang": TYPES["gang"]}, 8, [
        (0.0, [_node(b"head", HEAD, demands=[{GANG_HEAD: 1}])]),
        (1.0, [_node(b"head", HEAD, demands=[{GANG_HEAD: 1}]),
               _node(b"g0h0", {**TYPES["gang"]["resources"], GANG_HEAD: 1})]),
        (2.0, [_node(b"head", HEAD),
               _node(b"g0h0", {**TYPES["gang"]["resources"], GANG_HEAD: 1},
                     {"CPU": 8, "GPU": 8, "GPU-H100": 8.0}),
               _node(b"g0h1", TYPES["gang"]["resources"])]),
        (3.0, [_node(b"head", HEAD),
               _node(b"g0h0", {**TYPES["gang"]["resources"], GANG_HEAD: 1}),
               _node(b"g0h1", TYPES["gang"]["resources"])]),
        (4.0 + IDLE_S, [_node(b"head", HEAD),
                        _node(b"g0h0",
                              {**TYPES["gang"]["resources"], GANG_HEAD: 1}),
                        _node(b"g0h1", TYPES["gang"]["resources"])]),
    ]),
}


class _ScriptedGcs:
    def __init__(self, steps, clock):
        self._steps = list(steps)
        self._clock = clock

    def call(self, method, **kw):
        assert method == "get_cluster_load", method
        t, load = self._steps.pop(0)
        self._clock.now = t
        return [dict(n, total=dict(n["total"]),
                     available=dict(n["available"]),
                     pending_demands=[dict(d) for d in n["pending_demands"]])
                for n in load]

    def close(self):
        pass


def _run(monkeypatch, autoscaler_mod, make, steps):
    clock = types.SimpleNamespace(now=0.0)
    gcs = _ScriptedGcs(steps, clock)
    monkeypatch.setattr(autoscaler_mod, "RpcClient", lambda *a, **k: gcs)
    monkeypatch.setattr(autoscaler_mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock.now, time=time.time, sleep=time.sleep))
    provider = _Recorder()
    scaler = make(provider)
    outs = [scaler.update() for _ in steps]
    return provider.calls, outs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decisions_match_the_jax_package(monkeypatch, scenario):
    """The same load sequence through both packages' StandardAutoscaler
    and PodAutoscaler: the same provider calls in the same order."""
    from ray_tpu.autoscaler import autoscaler as ref_std
    from ray_tpu.autoscaler import pod_autoscaler as ref_pod

    from ray_tpu_torch.autoscaler import autoscaler as std
    from ray_tpu_torch.autoscaler import pod_autoscaler as pod

    types_, max_workers, steps = SCENARIOS[scenario]
    config = {"available_node_types": types_, "max_workers": max_workers,
              "idle_timeout_minutes": IDLE_S / 60.0}
    got = {}
    for name, s_mod, p_mod in (("ref", ref_std, ref_pod),
                               ("port", std, pod)):
        got[name, "standard"] = _run(
            monkeypatch, s_mod, lambda prov: s_mod.StandardAutoscaler(
                ("127.0.0.1", 1), prov, types_, max_workers=max_workers,
                idle_timeout_s=IDLE_S), steps)
        got[name, "pod"] = _run(
            monkeypatch, p_mod, lambda prov: p_mod.PodAutoscaler(
                ("127.0.0.1", 1), prov, config), steps)
    for kind in ("standard", "pod"):
        assert got["port", kind] == got["ref", kind], kind


def test_decision_scenarios_cover_their_cases(monkeypatch):
    """What each scenario is there for shows in the port's calls."""
    from ray_tpu_torch.autoscaler import autoscaler as std
    from ray_tpu_torch.autoscaler import pod_autoscaler as pod

    def calls(scenario):
        types_, max_workers, steps = SCENARIOS[scenario]
        config = {"available_node_types": types_,
                  "max_workers": max_workers,
                  "idle_timeout_minutes": IDLE_S / 60.0}
        return (_run(monkeypatch, std, lambda prov: std.StandardAutoscaler(
                    ("127.0.0.1", 1), prov, types_, max_workers=max_workers,
                    idle_timeout_s=IDLE_S), steps)[0],
                _run(monkeypatch, pod, lambda prov: pod.PodAutoscaler(
                    ("127.0.0.1", 1), prov, config), steps)[0])

    std_calls, pod_calls = calls("infeasible")
    assert std_calls == [("create_node", "gpu")]          # not for TPU
    assert pod_calls == [("create_node_group", "gpu", 1)]
    assert calls("fits_somewhere") == ([], [])
    std_calls, _ = calls("covered_by_pending")
    assert std_calls == [("create_node", "gpu"), ("create_node", "gpu")]
    std_calls, pod_calls = calls("max_workers_cap")
    assert std_calls == [("create_node", "gpu")] * 2
    std_calls, pod_calls = calls("idle_timeout_vs_min_workers")
    # The idle CPU node goes; the GPU node stays at its min_workers.
    assert ("terminate_node", "g0h0") in std_calls
    assert not any(c[0] == "terminate_node" and c[1] == "g1h0"
                   for c in std_calls)
    assert ("terminate_node_group", "g0") in pod_calls
    std_calls, pod_calls = calls("gang")
    assert std_calls == []                 # one host has no head resource
    assert pod_calls == [("create_node_group", "gang", 2),
                         ("terminate_node_group", "g0")]


# --------------------------------------------- what only the port does

@pytest.mark.timeout(120)
def test_actor_demand_scales_up(cluster):
    """An actor that no node can take waits in the GCS, not in a raylet's
    lease queue: the GCS reports its demand in ``get_cluster_load``, the
    autoscaler launches a GPU node, the actor lands there, and once it is
    gone the node scales down."""
    w = _worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    autoscaler = StandardAutoscaler(
        w.gcs_addr, provider, available_node_types={"gpu.node": GPU_NODE},
        max_workers=1, idle_timeout_s=2.0)

    @ray_tpu_torch.remote(num_gpus=1)
    class OnTheCard:
        def where(self):
            import os

            return (ray_tpu_torch.get_runtime_context().get_node_id(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    try:
        actor = OnTheCard.remote()
        demands = _until(
            lambda: [d for n in w.gcs.call("get_cluster_load", timeout=10)
                     for d in n["pending_demands"]], 20,
            "the actor's demand never reached get_cluster_load", 0.1)
        assert demands == [{"CPU": 1.0, "GPU": 1.0}]
        assert autoscaler.update()["launched"] == 1
        node_id, visible = ray_tpu_torch.get(actor.where.remote(),
                                             timeout=60)
        pid = provider.non_terminated_nodes()[0]
        assert provider.internal_node_id(pid).hex() == node_id
        assert visible == "0"
        # Placed: the demand is gone.
        assert not [d for n in w.gcs.call("get_cluster_load", timeout=10)
                    for d in n["pending_demands"]]
        ray_tpu_torch.kill(actor)
        _until(lambda: autoscaler.update()["terminated"], 60,
               "the GPU node never scaled down")
        assert provider.non_terminated_nodes() == []
        _until(lambda: "GPU" not in ray_tpu_torch.cluster_resources(), 60,
               "the GPU stayed in cluster_resources()")
    finally:
        provider.shutdown()


@pytest.mark.timeout(120)
def test_node_reads_idle_after_fractional_leases(cluster):
    """Scale-down takes a node as idle when its ``available`` equals its
    ``total`` (a dict equality): after leases of 0.3, 0.3 and 0.1 of its
    card, and with the ``GPU-H100`` tag, it does again once they end."""
    w = _worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    try:
        pid = provider.create_node("gpu.node", {"resources": dict(
            GPU1, CPU=4)})
        internal = _until(lambda: provider.internal_node_id(pid), 30,
                          "no node id")

        def load():
            return next((n for n in w.gcs.call("get_cluster_load",
                                               timeout=10)
                         if n["node_id"] == internal), None)

        node = _until(load, 30, "the node never joined", 0.1)
        assert node["total"]["GPU"] == 1.0 and \
            node["total"]["GPU-H100"] == 1.0

        @ray_tpu_torch.remote
        def hold(seconds):
            time.sleep(seconds)
            return ray_tpu_torch.get_runtime_context().get_node_id()

        refs = [hold.options(num_gpus=f).remote(1.0)
                for f in (0.3, 0.3, 0.1)]
        _until(lambda: load()["available"] != load()["total"], 30,
               "the leases never showed", 0.05)
        assert set(ray_tpu_torch.get(refs, timeout=60)) == {internal.hex()}
        idle = _until(lambda: (lambda n: n if n["available"] == n["total"]
                               else None)(load()), 30,
                      "the node never read idle again", 0.1)
        assert idle["available"]["GPU"] == 1.0
    finally:
        provider.shutdown()


@pytest.mark.timeout(120)
def test_task_demand_clears_once_a_node_can_take_it(cluster):
    """A raylet records a lease it found infeasible for 10 s, for the
    autoscaler to see; once a node that can take it has joined, the next
    lease request of that shape drops the record, so a whole-GPU task that
    already ran launches no second node."""
    w = _worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    autoscaler = StandardAutoscaler(
        w.gcs_addr, provider, available_node_types={"gpu.node": GPU_NODE},
        max_workers=3, idle_timeout_s=60.0)

    @ray_tpu_torch.remote(num_gpus=1)
    def on_the_card():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    try:
        ref = on_the_card.remote()
        _until(lambda: autoscaler.update()["launched"], 30,
               "the autoscaler never scaled up", period=0.5)
        t_ran = time.monotonic()
        ray_tpu_torch.get(ref, timeout=60)
        _until(lambda: not [d for n in w.gcs.call("get_cluster_load",
                                                  timeout=10)
                            for d in n["pending_demands"]], 30,
               "the demand stayed in get_cluster_load", 0.1)
        # Well before the record's 10 s life would end it.
        assert time.monotonic() - t_ran < 7.0
        assert autoscaler.update()["launched"] == 0
        assert len(provider.non_terminated_nodes()) == 1
    finally:
        provider.shutdown()


# ------------------------------------- a node that joins past the deadline

LEASE_MS = 1500


@pytest.fixture
def short_lease_cluster(monkeypatch):
    """The ``cluster`` fixture's head with a lease deadline of 1.5 s."""
    monkeypatch.setenv(G.FAKE_GPUS_ENV, "1")
    monkeypatch.setenv(G.FAKE_GPU_TYPE_ENV, "H100")
    monkeypatch.setenv("RAY_TPU_worker_lease_timeout_ms", str(LEASE_MS))
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024)
    yield info
    ray_tpu_torch.shutdown()


class SlowBootProvider(FakeMultiNodeProvider):
    """A node that starts booting only ``boot_s`` after it is asked for
    (past the lease deadline), as a cloud VM boots before it runs
    ``ray_tpu_torch start``. The monitor makes no poll meanwhile, which
    stays well inside the GCS's window of two 5 s periods."""

    boot_s = 2.5

    def create_node(self, node_type, node_config):
        time.sleep(self.boot_s)
        return super().create_node(node_type, node_config)


def _monitor(autoscaler, stop, period=0.5):
    """A monitor loop in a thread: one ``update()`` every ``period``."""
    import threading

    def loop():
        while not stop.is_set():
            try:
                autoscaler.update()
            except Exception:
                pass
            stop.wait(period)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


@pytest.mark.timeout(120)
def test_actor_outlives_its_deadline_while_an_autoscaler_runs(
        short_lease_cluster):
    """An actor that no live node can fit waits past its lease deadline
    while a running autoscaler reads its demand, and lands on the node
    that joins later; one ACTOR_PENDING warning names it. A task of the
    same demand waits the same way."""
    import threading

    from ray_tpu_torch.util import state

    w = _worker()
    provider = SlowBootProvider(w.gcs_addr, w.session_dir)
    autoscaler = StandardAutoscaler(
        w.gcs_addr, provider, available_node_types={"gpu.node": GPU_NODE},
        max_workers=1, idle_timeout_s=60.0)

    @ray_tpu_torch.remote(num_gpus=1)
    class OnTheCard:
        def where(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    @ray_tpu_torch.remote(num_gpus=1)
    def on_the_card():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    stop = threading.Event()
    monitor = _monitor(autoscaler, stop)
    try:
        actor = OnTheCard.remote()
        ref = on_the_card.remote()
        node_id = ray_tpu_torch.get(actor.where.remote(), timeout=90)
        assert ray_tpu_torch.get(ref, timeout=60) == node_id
        pid = provider.non_terminated_nodes()[0]
        assert provider.internal_node_id(pid).hex() == node_id
        # The one warning: the actor outlived its deadline, waiting.
        events = state.list_cluster_events(event_type="ACTOR_PENDING")
        assert len(events) == 1
        assert events[0]["severity"] == "WARNING"
        assert events[0]["actor_id"] == actor._actor_id.hex()
        ray_tpu_torch.kill(actor)
    finally:
        stop.set()
        monitor.join(timeout=30)
        provider.shutdown()


@pytest.mark.timeout(60)
def test_actor_dies_at_its_deadline_without_an_autoscaler(
        short_lease_cluster):
    """With no autoscaler reading the load, an actor that no node can fit
    dies at its lease deadline, as in the reference."""
    from ray_tpu_torch.exceptions import ActorDiedError
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote(num_gpus=1)
    class OnTheCard:
        def where(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    actor = OnTheCard.remote()
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(actor.where.remote(), timeout=30)
    assert not state.list_cluster_events(event_type="ACTOR_PENDING")
