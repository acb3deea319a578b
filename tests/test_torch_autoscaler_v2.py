"""Autoscaler v2 on the port (``ray_tpu_torch.autoscaler.v2``): the
reference's own ``tests/test_autoscaler_v2.py`` cases (lifecycle
legality, persistence, the reconciler's scale up, join and down, and its
crash resume), with the reconciler's demand a ``num_gpus=1`` task on a head
without a GPU; and the instance table held to the JAX package's: the same
transitions, with ids and clocks fixed, write the same KV rows, and a
table the JAX package wrote loads in the port.
"""

import itertools
import json
import time
import types

import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators import gpu as G
from ray_tpu_torch.autoscaler import FakeMultiNodeProvider
from ray_tpu_torch.autoscaler.v2 import (
    Instance, InstanceManager, InstanceStatus, Reconciler,
)
from ray_tpu_torch.autoscaler.v2.instance_manager import (
    KV_KEY, InvalidTransition,
)


class _DictKV:
    def __init__(self):
        self.d = {}

    def get(self, k):
        return self.d.get(k)

    def put(self, k, v):
        self.d[k] = v


@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setenv(G.FAKE_GPUS_ENV, "1")
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024)
    yield info
    ray_tpu_torch.shutdown()


# ----------------------------------------------------------- state machine
def test_lifecycle_transitions_and_illegal_ones():
    kv = _DictKV()
    im = InstanceManager(kv.get, kv.put)
    inst = im.add("worker.small")
    assert inst.status == InstanceStatus.QUEUED

    im.transition(inst.instance_id, InstanceStatus.REQUESTED)
    im.transition(inst.instance_id, InstanceStatus.ALLOCATED,
                  cloud_instance_id="c-1")
    im.transition(inst.instance_id, InstanceStatus.RAY_RUNNING,
                  node_id="ab" * 14)
    with pytest.raises(InvalidTransition):
        im.transition(inst.instance_id, InstanceStatus.QUEUED)
    im.transition(inst.instance_id, InstanceStatus.TERMINATING)
    im.transition(inst.instance_id, InstanceStatus.TERMINATED)
    with pytest.raises(InvalidTransition):
        im.transition(inst.instance_id, InstanceStatus.RAY_RUNNING)
    # Full history retained for debugging (reference keeps the same).
    assert len(im.instances[inst.instance_id].history) == 6


def test_table_persists_and_reloads():
    kv = _DictKV()
    im = InstanceManager(kv.get, kv.put)
    a = im.add("t1")
    im.add("t2")
    im.transition(a.instance_id, InstanceStatus.REQUESTED)
    v = im.version

    # "Crash": a brand-new manager over the same storage sees everything.
    im2 = InstanceManager(kv.get, kv.put)
    assert im2.version == v
    assert set(im2.instances) == set(im.instances)
    assert im2.instances[a.instance_id].status == InstanceStatus.REQUESTED
    # and continues versioning from there
    im2.add("t3")
    assert im2.version == v + 1


# -------------------------------------------------- rows against the JAX
def _fixed(monkeypatch, mod):
    """Ids 000000000001, ... and a clock of 1000.0, 1001.0, ... in the
    instance manager ``mod``: its module's ``uuid`` and ``time``, and the
    ``time.time`` that ``Instance``'s dataclass ``__init__`` holds as the
    default of ``status_since``."""
    ids = itertools.count(1)
    clock = itertools.count(1000)

    def now():
        return float(next(clock))

    monkeypatch.setattr(mod, "uuid", types.SimpleNamespace(
        uuid4=lambda: types.SimpleNamespace(hex=f"{next(ids):012x}" * 3)))
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=now))
    init = mod.Instance.__init__
    cell = init.__closure__[init.__code__.co_freevars.index(
        "__dataclass_dflt_status_since__")]
    assert cell.cell_contents is time.time
    monkeypatch.setattr(cell, "cell_contents", now)


S = InstanceStatus
SEQUENCES = {
    "launch_join_idle_down": [
        ("add", "gpu.h100"), ("to", 0, S.REQUESTED, {}),
        ("to", 0, S.ALLOCATED, {"cloud_instance_id": "group-gpu-1"}),
        ("to", 0, S.RAY_RUNNING, {"node_id": "ab" * 28}),
        ("to", 0, S.RAY_STOPPING, {}), ("to", 0, S.TERMINATING, {}),
        ("to", 0, S.TERMINATED, {})],
    "failed_create_and_requeue": [
        ("add", "gpu.h100"), ("add", "cpu.worker"),
        ("to", 0, S.REQUESTED, {}), ("to", 0, S.ALLOCATION_FAILED, {}),
        ("to", 1, S.REQUESTED, {}), ("to", 1, S.TERMINATED, {}),
        ("add", "gpu.h100")],
    "adopted_then_vanished": [
        ("add", "unknown"), ("to", 0, S.REQUESTED, {}),
        ("to", 0, S.ALLOCATED, {"cloud_instance_id": "fake-x"}),
        ("to", 0, S.TERMINATED, {})],
}


def _play(mod, steps):
    kv = _DictKV()
    im = mod.InstanceManager(kv.get, kv.put)
    ids, rows = [], []
    for step in steps:
        if step[0] == "add":
            ids.append(im.add(step[1]).instance_id)
        else:
            _, i, status, fields = step
            im.transition(ids[i], status, **fields)
        rows.append(kv.d[mod.KV_KEY])
    return rows


@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_kv_rows_equal_the_jax_package(monkeypatch, sequence):
    """Every write of the table, as bytes in the KV, equals the JAX
    package's for the same transitions."""
    from ray_tpu.autoscaler.v2 import instance_manager as ref

    from ray_tpu_torch.autoscaler.v2 import instance_manager as port

    _fixed(monkeypatch, ref)
    want = _play(ref, SEQUENCES[sequence])
    _fixed(monkeypatch, port)
    got = _play(port, SEQUENCES[sequence])
    assert got == want
    assert port.KV_KEY == ref.KV_KEY
    doc = json.loads(got[-1])
    assert doc["version"] == len(SEQUENCES[sequence])


def test_table_written_by_the_jax_package_loads_in_the_port():
    from ray_tpu.autoscaler.v2 import instance_manager as ref

    kv = _DictKV()
    rim = ref.InstanceManager(kv.get, kv.put)
    a = rim.add("gpu.h100")
    rim.transition(a.instance_id, ref.InstanceStatus.REQUESTED)
    rim.transition(a.instance_id, ref.InstanceStatus.ALLOCATED,
                   cloud_instance_id="c-9")
    b = rim.add("cpu.worker")

    im = InstanceManager(kv.get, kv.put)
    assert im.version == rim.version
    assert {k: i.to_row() for k, i in im.instances.items()} == \
        {k: i.to_row() for k, i in rim.instances.items()}
    assert im.by_cloud_id("c-9").instance_id == a.instance_id
    assert [i.instance_id for i in im.active()] == [a.instance_id,
                                                    b.instance_id]
    # The port goes on from the reference's version.
    im.transition(a.instance_id, InstanceStatus.RAY_RUNNING, node_id="cd")
    assert json.loads(kv.d[KV_KEY])["version"] == rim.version + 1
    assert isinstance(im.instances[b.instance_id], Instance)


# -------------------------------------------------------------- reconciler
NODE_TYPES = {
    "gpu.node": {"resources": {"CPU": 2, "GPU": 1},
                 "min_workers": 0, "max_workers": 3},
}


@pytest.mark.timeout(150)
def test_reconciler_scales_up_joins_and_down(cluster):
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    rec = Reconciler(w.gcs_addr, provider, NODE_TYPES,
                     max_workers=3, idle_timeout_s=3.0)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        def needs():
            return ray_tpu_torch.get_runtime_context().get_node_id()

        ref = needs.remote()

        launched = 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and launched == 0:
            time.sleep(1.0)
            launched = rec.reconcile()["launched"]
        assert launched == 1

        node_id = ray_tpu_torch.get(ref, timeout=90)

        # Reconcile until the join is observed as RAY_RUNNING.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rec.reconcile()
            running = rec.im.with_status(InstanceStatus.RAY_RUNNING)
            if running:
                break
            time.sleep(0.5)
        assert running and running[0].node_id == node_id

        # Idle past the timeout -> full STOPPING/TERMINATING/TERMINATED
        # walk, recorded in the history.
        terminated = 0
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and terminated == 0:
            time.sleep(1.0)
            terminated = rec.reconcile()["terminated"]
        assert terminated == 1
        assert provider.non_terminated_nodes() == []
        hist = rec.im.instances[running[0].instance_id].history
        assert any("RAY_STOPPING" in h for h in hist)
        assert any("TERMINATED" in h for h in hist)
        # The table lives in the GCS KV, in the reference's layout.
        raw = w.gcs.call("kv_get", namespace="autoscaler", key=KV_KEY,
                         timeout=10)
        doc = json.loads(raw if isinstance(raw, str) else raw.decode())
        assert doc["version"] == rec.im.version
        assert set(doc["instances"][0]) == set(Instance(
            instance_id="x", node_type="y").to_row())
    finally:
        provider.shutdown()


@pytest.mark.timeout(150)
def test_reconciler_crash_resume_adopts_and_requeues(cluster):
    """A new Reconciler over the same GCS KV (autoscaler restart) resumes
    the table: live cloud nodes are re-recognized, and a REQUESTED row
    whose create never completed is retired for re-evaluation."""
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    provider = FakeMultiNodeProvider(w.gcs_addr, w.session_dir)
    rec1 = Reconciler(w.gcs_addr, provider, NODE_TYPES, max_workers=3)
    try:
        # A live cloud node tracked by rec1.
        inst = rec1.im.add("gpu.node")
        rec1.reconcile()  # launches it
        assert rec1.im.instances[inst.instance_id].status in (
            InstanceStatus.ALLOCATED, InstanceStatus.RAY_RUNNING)

        # Simulate a crash mid-launch: a REQUESTED row with no cloud id.
        orphan = rec1.im.add("gpu.node")
        rec1.im.transition(orphan.instance_id, InstanceStatus.REQUESTED)

        # Restarted autoscaler process.
        rec2 = Reconciler(w.gcs_addr, provider, NODE_TYPES, max_workers=3)
        assert set(rec2.im.instances) == set(rec1.im.instances)
        stats = rec2.reconcile()
        assert stats["requeued"] == 1
        assert (rec2.im.instances[orphan.instance_id].status
                == InstanceStatus.TERMINATED)
        # The real node survived the restart and is still tracked.
        live = rec2.im.instances[inst.instance_id]
        assert live.status in (InstanceStatus.ALLOCATED,
                               InstanceStatus.RAY_RUNNING)
        assert live.cloud_instance_id in provider.non_terminated_nodes()

        # An untracked (manually-launched) cloud node is adopted.
        extra = provider.create_node("gpu.node", NODE_TYPES["gpu.node"])
        stats = rec2.reconcile()
        assert stats["adopted"] == 1
        adopted = rec2.im.by_cloud_id(extra)
        assert adopted is not None and adopted.status in (
            InstanceStatus.ALLOCATED, InstanceStatus.RAY_RUNNING)
    finally:
        provider.shutdown()
