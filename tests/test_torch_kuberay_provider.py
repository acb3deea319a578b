"""The KubeRay provider on the port (``ray_tpu_torch.autoscaler.
kuberay_provider``) against the reference's own mocked Kubernetes API
server and kuberay-operator emulator (``tests/test_kuberay_provider.py``'s
``FakeKubeApi``): the reference's nine cases, each asserting what it
asserts there, and each driven through both packages' providers by the
same scripted calls, which must send the same requests (method, path,
body) in the same order. A GPU gang is a multi-host worker group
(``numOfHosts``). The reconciler's case runs both packages' v2
reconcilers over a scripted GCS, then the port's over its own cluster.
"""

import copy
import types

import pytest

import ray_tpu_torch
import test_kuberay_provider as REF
from ray_tpu_torch.autoscaler import kuberay_provider as K
from ray_tpu_torch.autoscaler.kuberay_provider import (
    KubeRayError, KubeRayProvider,
)

# Nothing listens there: a lookup in the GCS node table fails at once.
GCS_ADDR = ("127.0.0.1", 1)
PROVIDER_CFG = REF.PROVIDER_CFG


class _Clock:
    """A monotonic clock that moves only when the provider sleeps, so
    both packages' TTL caches and ready waits see the same times."""

    def __init__(self):
        self.now = 100.0

    def module(self):
        return types.SimpleNamespace(monotonic=lambda: self.now,
                                     sleep=self.sleep, time=lambda: self.now)

    def sleep(self, s):
        self.now += s


class _Recording:
    def __init__(self, api):
        self.api = api
        self.requests = []

    def __call__(self, method, path, body=None, **kw):
        self.requests.append((method, path, copy.deepcopy(body)))
        return self.api(method, path, body, **kw)


def _both(monkeypatch, groups, script, conflict_every=0):
    """Run ``script(provider, api)`` on each package's provider over its
    own fake API server; returns {package: (requests, result, api)} and
    asserts the request lists equal."""
    from ray_tpu.autoscaler import kuberay_provider as ref_k

    out = {}
    for name, mod in (("ref", ref_k), ("port", K)):
        monkeypatch.setattr(mod, "time", _Clock().module())
        api = REF.FakeKubeApi(REF.make_cr(groups),
                              conflict_every=conflict_every)
        rec = _Recording(api)
        provider = mod.KubeRayProvider(PROVIDER_CFG, GCS_ADDR, transport=rec,
                                       ready_timeout_s=5,
                                       poll_interval_s=0.01)
        try:
            result = ("ok", script(provider, api))
        except Exception as e:          # both must fail the same way
            result = (type(e).__name__, str(e))
        out[name] = (rec.requests, result, api)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    return out["port"]


def test_create_node_scales_replicas_and_waits_for_pod(monkeypatch):
    def script(p, api):
        pid = p.create_node("cpu-group", {})
        return pid, p.non_terminated_nodes(), p.node_type_of(pid)

    requests, (_, (pid, nodes, node_type)), api = _both(
        monkeypatch, [("cpu-group", 1)], script)
    assert api.cr["spec"]["workerGroupSpecs"][0]["replicas"] == 1
    assert nodes == [pid]
    assert node_type == "cpu-group"
    assert [r[0] for r in requests[:3]] == ["GET", "GET", "PUT"]


def test_gang_create_makes_numOfHosts_pods(monkeypatch):
    def script(p, api):
        gid = p.create_node_group("gpu-h100-16", {}, 2)
        return (gid, p.node_groups(), p.group_nodes(gid),
                p.group_type_of(gid))

    _, (_, (gid, groups, hosts, gtype)), api = _both(
        monkeypatch, [("gpu-h100-16", 2)], script)
    assert groups == [gid]
    assert len(hosts) == 2
    assert gtype == "gpu-h100-16"
    # One replica of the multi-host group, not two.
    assert api.cr["spec"]["workerGroupSpecs"][0]["replicas"] == 1


def test_gang_size_mismatch_rejected(monkeypatch):
    _, result, _ = _both(monkeypatch, [("gpu-h100-16", 2)],
                         lambda p, api: p.create_node_group(
                             "gpu-h100-16", {}, 4))
    assert result[0] == "KubeRayError" and "numOfHosts" in result[1]
    api = REF.FakeKubeApi(REF.make_cr([("gpu-h100-16", 2)]))
    with pytest.raises(KubeRayError, match="numOfHosts"):
        KubeRayProvider(PROVIDER_CFG, GCS_ADDR, transport=api,
                        ready_timeout_s=5, poll_interval_s=0.01
                        ).create_node_group("gpu-h100-16", {}, 4)


def test_unknown_group_rejected(monkeypatch):
    _, result, _ = _both(monkeypatch, [("cpu-group", 1)],
                         lambda p, api: p.create_node("nope", {}))
    assert result[0] == "KubeRayError" and "no workerGroupSpec" in result[1]


def test_terminate_uses_workersToDelete(monkeypatch):
    def script(p, api):
        pid = p.create_node("cpu-group", {})
        p.terminate_node(pid)
        return pid, p.non_terminated_nodes()

    requests, (_, (pid, nodes)), api = _both(
        monkeypatch, [("cpu-group", 1)], script)
    assert nodes == []
    assert api.cr["spec"]["workerGroupSpecs"][0]["replicas"] == 0
    last_put = [r for r in requests if r[0] == "PUT"][-1]
    assert last_put[2]["spec"]["workerGroupSpecs"][0]["scaleStrategy"][
        "workersToDelete"] == [pid]


def test_terminating_one_gang_member_kills_the_gang(monkeypatch):
    def script(p, api):
        gid = p.create_node_group("gpu-h100-16", {}, 2)
        p.terminate_node(p.group_nodes(gid)[1])
        return p.non_terminated_nodes()

    _, (_, nodes), _ = _both(monkeypatch, [("gpu-h100-16", 2)], script)
    assert nodes == []


def test_cr_write_conflicts_are_retried(monkeypatch):
    def script(p, api):
        pids = [p.create_node("cpu-group", {}) for _ in range(2)]
        return pids, p.non_terminated_nodes()

    requests, (_, (pids, nodes)), api = _both(
        monkeypatch, [("cpu-group", 1)], script, conflict_every=2)
    assert nodes == sorted(pids)
    # The second write met a 409 and was sent again.
    assert api.writes == 3
    assert [r[0] for r in requests].count("PUT") == 3


def test_yaml_wiring():
    from ray_tpu_torch.autoscaler.config import (
        make_provider, validate_cluster_config,
    )

    cfg = validate_cluster_config({
        "cluster_name": "demo",
        "provider": PROVIDER_CFG,
        "available_node_types": {"gpu-group": {"node_config": {
            "gpu": "H100-16"}}},
    })
    assert cfg["available_node_types"]["gpu-group"]["gang_size"] == 2
    provider = make_provider(cfg, GCS_ADDR, "/tmp/nowhere")
    assert isinstance(provider, KubeRayProvider)


class _ScriptedGcs:
    def __init__(self, loads):
        self.loads = list(loads)
        self.kv = {}

    def call(self, method, **kw):
        if method == "get_cluster_load":
            return copy.deepcopy(self.loads[0] if len(self.loads) == 1
                                 else self.loads.pop(0))
        if method == "kv_get":
            return self.kv.get((kw["namespace"], kw["key"]))
        if method == "kv_put":
            self.kv[kw["namespace"], kw["key"]] = kw["value"]
            return True
        raise AssertionError(method)


def test_reconciler_drives_kuberay_lifecycle(monkeypatch):
    """v2 reconciler end to end over the mocked k8s API, each package's
    over a scripted GCS: pending demand -> replica bump -> operator pods
    -> ALLOCATED instances; vanished pod -> instance TERMINATED, and a
    replacement for the demand still pending. The two send the same
    requests."""
    from ray_tpu.autoscaler import kuberay_provider as ref_k
    from ray_tpu.autoscaler.v2 import reconciler as ref_rec

    from ray_tpu_torch.autoscaler.v2 import reconciler as rec_mod

    head = {"node_id": b"head", "total": {"CPU": 4}, "available": {"CPU": 4},
            "pending_demands": [{"GPU": 1.0, "CPU": 1.0}]}
    types_ = {"gpu-group": {"resources": {"CPU": 2, "GPU": 1},
                            "min_workers": 0, "max_workers": 3}}

    def script(p, api, mod):
        monkeypatch.setattr(mod, "RpcClient",
                            lambda *a, **k: _ScriptedGcs([[head]]))
        monkeypatch.setattr(mod, "time", _Clock().module())
        rec = mod.Reconciler(GCS_ADDR, p, types_, max_workers=3,
                             idle_timeout_s=2.0)
        stats = [rec.reconcile()]
        allocated = rec.im.with_status("ALLOCATED")
        cid = allocated[0].cloud_instance_id
        nodes = p.non_terminated_nodes()
        api.pods.pop(cid)
        p._pods_cache.clear()           # past the listing TTL
        stats.append(rec.reconcile())
        return (stats, len(allocated), cid in nodes,
                rec.im.instances[allocated[0].instance_id].status,
                api.cr["spec"]["workerGroupSpecs"][0]["replicas"])

    got = {}
    for name, mod, kmod in (("ref", ref_rec, ref_k), ("port", rec_mod, K)):
        monkeypatch.setattr(kmod, "time", _Clock().module())
        api = REF.FakeKubeApi(REF.make_cr([("gpu-group", 1)]))
        recd = _Recording(api)
        provider = kmod.KubeRayProvider(PROVIDER_CFG, None, transport=recd,
                                        ready_timeout_s=5,
                                        poll_interval_s=0.01)
        got[name] = (recd.requests, script(provider, api, mod))
    assert got["port"] == got["ref"]
    stats, n_allocated, listed, status, replicas = got["port"][1]
    assert stats[0]["launched"] == 1 and n_allocated == 1 and listed
    # The demand is still pending: the next pass replaces the lost pod.
    assert status == "TERMINATED" and stats[1]["launched"] == 1
    assert replicas == 2


@pytest.fixture
def cluster():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024)
    yield info
    ray_tpu_torch.shutdown()


@pytest.mark.timeout(90)
def test_reconciler_drives_kuberay_lifecycle_on_the_port(cluster):
    """The reference's case as it runs there, on the port's cluster: a
    ``num_gpus=1`` task's pending demand bumps the GPU group's replicas."""
    import time

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.autoscaler.v2.instance_manager import InstanceStatus
    from ray_tpu_torch.autoscaler.v2.reconciler import Reconciler

    w = global_worker()
    api = REF.FakeKubeApi(REF.make_cr([("gpu-group", 1)]))
    provider = KubeRayProvider(PROVIDER_CFG, w.gcs_addr, transport=api,
                               ready_timeout_s=5, poll_interval_s=0.01)
    types_ = {"gpu-group": {"resources": {"CPU": 2, "GPU": 1},
                            "min_workers": 0, "max_workers": 3}}
    rec = Reconciler(w.gcs_addr, provider, types_, max_workers=3,
                     idle_timeout_s=2.0)

    @ray_tpu_torch.remote(num_gpus=1)
    def needs():
        return 1

    ref = needs.remote()  # pending demand the cluster can't satisfy
    try:
        launched = 0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and launched == 0:
            launched = rec.reconcile()["launched"]
            time.sleep(0.2)
        assert launched == 1
        assert api.cr["spec"]["workerGroupSpecs"][0]["replicas"] == 1
        allocated = rec.im.with_status(InstanceStatus.ALLOCATED)
        assert len(allocated) == 1
        cid = allocated[0].cloud_instance_id
        assert cid in provider.non_terminated_nodes()

        api.pods.pop(cid)
        provider._pods_cache.clear()  # advance past the listing TTL
        rec.reconcile()
        inst = rec.im.instances[allocated[0].instance_id]
        assert inst.status == InstanceStatus.TERMINATED
    finally:
        ray_tpu_torch.cancel(ref, force=True)
