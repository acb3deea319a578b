"""The Compute Engine GPU-VM gang provider on the port
(``ray_tpu_torch.autoscaler.gcp_gpu_provider``) against a mocked Compute
API and a capturing command runner: the thirteen contracts of the
reference's ``tests/test_gcp_provider.py`` (its TPU-VM provider) on GPU
gangs: one bulk insert makes a gang, every host bootstraps with the
GCS address and its identity labels, host 0 alone carries the gang-head
resource, any failure deletes the whole gang, a transient poll error is
retried, a restarted monitor adopts its cluster's gangs; and the resource
names the port makes from config names equal the reference's.
"""

import re

import pytest

import test_gcp_provider as REF
from ray_tpu_torch.autoscaler import gcp_gpu_provider as P
from ray_tpu_torch.autoscaler.gcp_gpu_provider import (
    CommandRunner, GceGpuPodProvider,
)

PROVIDER_CFG = {"project": "proj", "zone": "us-central1-a",
                "cluster_name": "test", "type": "gcp_gpu"}
# Nothing listens there: a lookup in the GCS node table fails at once.
GCS_ADDR = ("127.0.0.1", 1)
ZONE = f"{P.COMPUTE_API}/projects/proj/zones/us-central1-a"
H100X8 = {"machine_type": "a3-highgpu-8g",
          "resources": {"CPU": 8, "GPU": 8, "GPU-H100": 8.0}}


class FakeComputeApi:
    """Compute Engine's instance API as a state machine: a bulk insert
    makes ``hosts`` instances (fewer than asked for a short gang), which
    turn RUNNING after ``delay_polls`` listings (or ``fail_state``), each
    with an internal IP; the insert's operation reads DONE."""

    def __init__(self, hosts=None, delay_polls=2, fail_state=None):
        self.hosts = hosts
        self.delay_polls = delay_polls
        self.fail_state = fail_state
        self.calls = []
        self.instances = {}          # name -> instance dict
        self.deleted = set()
        self.polls = 0
        self.ops = 0

    def __call__(self, method, url, body=None):
        self.calls.append((method, url, body))
        if method == "POST" and url == f"{ZONE}/instances/bulkInsert":
            props = body["instanceProperties"]
            names = list(body["perInstanceProperties"])
            n = self.hosts if self.hosts is not None else body["count"]
            for i, name in enumerate(names[:n]):
                self.instances[name] = {
                    "name": name, "status": "PROVISIONING",
                    "labels": dict(props["labels"]),
                    "metadata": props["metadata"],
                    "machineType": props["machineType"],
                    "networkInterfaces": [{"networkIP": f"10.1.0.{i}"}]}
            self.ops += 1
            return {"name": f"operation-{self.ops}", "status": "RUNNING"}
        if method == "GET" and "/instances?filter=labels." in url:
            label, value = url.split("filter=labels.")[1].split("%3D")
            self.polls += 1
            items = []
            for inst in self.instances.values():
                if inst["name"] in self.deleted or \
                        inst["labels"].get(label) != value:
                    continue
                if self.polls >= self.delay_polls:
                    inst["status"] = self.fail_state or "RUNNING"
                items.append(dict(inst))
            return {"items": items}
        if method == "GET" and "/operations/" in url:
            return {"name": url.rsplit("/", 1)[1], "status": "DONE"}
        if method == "DELETE" and url.startswith(f"{ZONE}/instances/"):
            self.deleted.add(url.rsplit("/", 1)[1])
            return {"name": "operation-delete"}
        raise AssertionError((method, url))

    def alive(self):
        return sorted(set(self.instances) - self.deleted)


class CapturingRunner(CommandRunner):
    def __init__(self, fail_on=None):
        self.commands = []
        self.fail_on = fail_on

    def run(self, host_ip, command):
        self.commands.append((host_ip, command))
        if self.fail_on == host_ip:
            raise RuntimeError(f"ssh to {host_ip} failed")


def _provider(api, runner, cfg=PROVIDER_CFG):
    return GceGpuPodProvider(cfg, GCS_ADDR, transport=api,
                             command_runner=runner, ready_timeout_s=10,
                             poll_interval_s=0.01)


def test_create_gang_bootstraps_every_host():
    api = FakeComputeApi()
    runner = CapturingRunner()
    p = _provider(api, runner)
    gid = p.create_node_group("gpu_h100_16", H100X8, 2)
    assert p.node_groups() == [gid]
    assert p.group_type_of(gid) == "gpu_h100_16"
    assert len(p.group_nodes(gid)) == 2
    assert len(runner.commands) == 2
    # Every host gets the join command with the GCS address, its cards
    # and its provider-group identity labels.
    for i, (ip, cmd) in enumerate(runner.commands):
        assert ip == f"10.1.0.{i}"
        assert "ray_tpu_torch start --address 127.0.0.1:1 " in cmd
        assert "--num-gpus 8" in cmd
        assert f'"provider_group": "{gid}"' in cmd
        assert f'"worker_index": "{i}"' in cmd
    # One bulk insert asked for the whole gang, all or none.
    posts = [c for c in api.calls if c[0] == "POST"]
    assert len(posts) == 1
    body = posts[0][2]
    assert body["count"] == body["minCount"] == 2
    assert body["instanceProperties"]["machineType"] == "a3-highgpu-8g"
    assert list(body["perInstanceProperties"]) == [f"{gid}-0", f"{gid}-1"]
    assert api.alive() == [f"{gid}-0", f"{gid}-1"]


def test_bootstrap_failure_rolls_back_whole_gang():
    api = FakeComputeApi()
    runner = CapturingRunner(fail_on="10.1.0.1")  # second host fails
    p = _provider(api, runner)
    with pytest.raises(RuntimeError, match="ssh to 10.1.0.1"):
        p.create_node_group("gpu_h100_16", H100X8, 2)
    assert p.node_groups() == []
    # Rollback: the gang was deleted, not leaked half-bootstrapped.
    assert any(c[0] == "DELETE" for c in api.calls)
    assert api.alive() == []


def test_api_failure_state_rolls_back():
    api = FakeComputeApi(fail_state="TERMINATED")
    p = _provider(api, CapturingRunner())
    with pytest.raises(RuntimeError, match="TERMINATED"):
        p.create_node_group("gpu_h100_16", H100X8, 2)
    assert any(c[0] == "DELETE" for c in api.calls)
    assert api.alive() == []


def test_short_gang_detected():
    """A gang RUNNING with fewer hosts than it needs, its insert done, is
    a config error, rolled back."""
    api = FakeComputeApi(hosts=1)
    p = _provider(api, CapturingRunner())
    with pytest.raises(RuntimeError, match="expected 2"):
        p.create_node_group("gpu_h100_16", H100X8, 2)
    assert api.alive() == []


def test_terminate_group_deletes_gang():
    api = FakeComputeApi()
    p = _provider(api, CapturingRunner())
    gid = p.create_node_group("gpu_h100_16", H100X8, 2)
    p.terminate_node_group(gid)
    assert p.node_groups() == []
    assert api.alive() == []


def test_single_node_facade():
    api = FakeComputeApi()
    p = _provider(api, CapturingRunner())
    nid = p.create_node("gpu_worker", {"machine_type": "a3-highgpu-1g"})
    assert nid.endswith("#0")
    assert p.node_type_of(nid) == "gpu_worker"
    assert p.non_terminated_nodes() == [nid]
    p.terminate_node(nid)
    assert p.non_terminated_nodes() == []
    assert api.alive() == []


def test_yaml_wiring():
    """`provider.type: gcp_gpu` resolves to the Compute Engine provider
    through the cluster-config loader."""
    from ray_tpu_torch.autoscaler.config import (
        make_provider, validate_cluster_config,
    )

    cfg = validate_cluster_config({
        "cluster_name": "demo",
        "provider": PROVIDER_CFG,
        "available_node_types": {
            "gpu_h100_16": {"node_config": {"gpu": "H100-16"}},
        },
    })
    spec = cfg["available_node_types"]["gpu_h100_16"]
    assert spec["gang_size"] == 2
    assert GceGpuPodProvider._machine_type(spec) == "a3-highgpu-8g"
    provider = make_provider(cfg, GCS_ADDR, "/tmp/nowhere")
    assert isinstance(provider, GceGpuPodProvider)


@pytest.mark.parametrize("node_config, want", [
    ({"gpu": "H100-8"}, "a3-highgpu-8g"),
    ({"gpu": "H100-16"}, "a3-highgpu-8g"),
    ({"gpu": "H100-2"}, "a3-highgpu-2g"),
    ({"gpu": "A100-16", "gpus_per_host": 4}, "a2-highgpu-4g"),
    ({"gpu": "H100-8", "machine_type": "a3-megagpu-8g"}, "a3-megagpu-8g"),
])
def test_machine_type_from_the_node_config(node_config, want):
    assert GceGpuPodProvider._machine_type(node_config) == want
    assert GceGpuPodProvider._machine_type(
        {"node_config": node_config}) == want


def test_machine_type_needs_a_known_card():
    with pytest.raises(ValueError, match="machine_type"):
        GceGpuPodProvider._machine_type({"gpu": "B200-8"})
    with pytest.raises(ValueError, match="machine_type"):
        GceGpuPodProvider._machine_type({})


def test_pod_autoscaler_gang_launch_through_provider():
    """A GPU-H100-16-head demand makes the PodAutoscaler launch one 2-host
    gang atomically via the provider (gang semantics end to end, GCS
    faked)."""
    from ray_tpu_torch.autoscaler.config import validate_cluster_config
    from ray_tpu_torch.autoscaler.pod_autoscaler import PodAutoscaler

    cfg = validate_cluster_config({
        "cluster_name": "demo",
        "max_workers": 8,
        "provider": PROVIDER_CFG,
        "available_node_types": {
            "gpu_h100_16": {"node_config": {"gpu": "H100-16"}},
        },
    })
    assert (cfg["available_node_types"]["gpu_h100_16"]["head_resources"]
            == {"GPU-H100-16-head": 1})
    api = FakeComputeApi()
    runner = CapturingRunner()
    provider = _provider(api, runner)
    provider._node_table = lambda: []       # no host has joined yet

    class FakeGcs:
        def call(self, method, **kw):
            assert method == "get_cluster_load"
            return [{"node_id": b"head", "total": {"CPU": 2},
                     "available": {"CPU": 2},
                     "pending_demands": [{"GPU-H100-16-head": 1}]}]

    autoscaler = PodAutoscaler.__new__(PodAutoscaler)
    autoscaler._gcs = FakeGcs()
    autoscaler.provider = provider
    autoscaler.config = cfg
    autoscaler.node_types = cfg["available_node_types"]
    autoscaler.max_hosts = cfg.get("max_workers", 8)
    autoscaler.idle_timeout_s = 300.0
    autoscaler._group_idle_since = {}

    out = autoscaler.update()
    assert out["launched"] == 1
    assert len(provider.node_groups()) == 1
    gid = provider.node_groups()[0]
    assert len(provider.group_nodes(gid)) == 2
    assert len(runner.commands) == 2
    # Second pass: capacity now pending-join covers the demand; no
    # duplicate gang.
    out2 = autoscaler.update()
    assert out2["launched"] == 0
    assert len(provider.node_groups()) == 1


def test_bootstrap_command_shape():
    api = FakeComputeApi()
    p = _provider(api, CapturingRunner())
    cmd = p._bootstrap_command("grp1", 2, {"resources": {"CPU": 8, "GPU": 4,
                                                         "GPU-H100": 4.0}})
    assert re.search(r"--address 127\.0\.0\.1:1 ", cmd)
    assert "--num-gpus 4 " in cmd and "--num-cpus 8 " in cmd
    assert '"worker_index": "2"' in cmd
    assert '"GPU-H100": 4.0' in cmd and '"GPU":' not in cmd
    assert cmd.startswith("python -m ray_tpu_torch start ")


def test_bootstrap_head_resource_on_worker0():
    """Host 0's join command carries the promoted gang-head resource;
    other hosts don't (gang-claim contract)."""
    api = FakeComputeApi()
    runner = CapturingRunner()
    p = _provider(api, runner)
    p.create_node_group(
        "gpu-h100-16", dict(H100X8, head_resources={"GPU-H100-16-head": 1}),
        2)
    head_cmds = [c for _, c in runner.commands if "GPU-H100-16-head" in c]
    assert len(head_cmds) == 1
    assert runner.commands[0][1] == head_cmds[0]
    assert "python -m ray_tpu_torch start" in head_cmds[0]


def test_node_name_sanitized():
    """Config-legal names (dots/underscores/caps) become RFC1035 names
    the Compute API accepts."""
    api = FakeComputeApi()
    p = _provider(api, CapturingRunner(),
                  {**PROVIDER_CFG, "cluster_name": "My_Cluster"})
    gid = p.create_node_group("gpu.h100_16", {"machine_type": "x-1"}, 1)
    assert re.fullmatch(r"[a-z]([-a-z0-9]*[a-z0-9])?", gid), gid
    for host in api.alive():
        assert re.fullmatch(r"[a-z]([-a-z0-9]*[a-z0-9])?", host), host


@pytest.mark.parametrize("cluster, node_type", [
    ("My_Cluster", "tpu.v5e_16"), ("a--b", "X..Y"), ("UPPER", "__gpu__"),
    ("ok", "gpu.h100"), ("dots.in.name", "-lead-and-trail-"),
])
def test_names_equal_the_reference_s(monkeypatch, cluster, node_type):
    """The group name each package makes from the same cluster and node
    type names, with the same random suffix."""
    from ray_tpu.autoscaler import gcp_tpu_provider as ref

    fixed = type("U", (), {"hex": "0123456789abcdef" * 2})
    monkeypatch.setattr(ref.uuid, "uuid4", lambda: fixed)
    monkeypatch.setattr(P.uuid, "uuid4", lambda: fixed)
    ref_p = ref.GceTpuPodProvider(
        {**REF.PROVIDER_CFG, "cluster_name": cluster}, GCS_ADDR,
        transport=REF.FakeTpuApi(hosts=1), command_runner=REF.CapturingRunner(),
        ready_timeout_s=5, poll_interval_s=0.01)
    want = ref_p.create_node_group(node_type, {"accelerator_type": "x-1"}, 1)
    port_p = _provider(FakeComputeApi(), CapturingRunner(),
                       {**PROVIDER_CFG, "cluster_name": cluster})
    got = port_p.create_node_group(node_type, {"machine_type": "x-1"}, 1)
    assert got == want
    assert got == P.rfc1035(f"ray-{cluster}-{node_type}-01234567")


def test_transient_poll_error_retries():
    """One flaky listing during the ready wait must not tear the gang
    down."""
    api = FakeComputeApi(delay_polls=3)
    calls = {"n": 0}

    def flaky(method, url, body=None):
        if method == "GET":
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("503 backend blip")
        return api(method, url, body)

    p = GceGpuPodProvider(PROVIDER_CFG, GCS_ADDR, transport=flaky,
                          command_runner=CapturingRunner(),
                          ready_timeout_s=10, poll_interval_s=0.01)
    gid = p.create_node_group("t", H100X8, 2)
    assert gid in p.node_groups()
    assert not any(c[0] == "DELETE" for c in api.calls)


def test_refresh_groups_adopts_running_gangs():
    """A restarted monitor rediscovers gangs labelled with its cluster (no
    orphaned billing, no duplicate min_workers launches)."""
    api = FakeComputeApi()
    runner = CapturingRunner()
    p1 = _provider(api, runner)
    gid = p1.create_node_group("gpu.h100x16", H100X8, 2)
    # Another cluster's instance in the same zone and project.
    api.instances["ray-other-x-0"] = {
        "name": "ray-other-x-0", "status": "RUNNING",
        "labels": {"ray-cluster": "test", "ray-group": "ray-other-x"},
        "metadata": {"items": [{"key": "ray-cluster",
                                "value": "someone-else"}]},
        "networkInterfaces": [{"networkIP": "10.9.9.9"}]}

    p2 = _provider(api, CapturingRunner())
    assert p2.node_groups() == []
    assert p2.refresh_groups() == 1
    assert p2.node_groups() == [gid]
    assert p2.group_type_of(gid) == "gpu.h100x16"
    assert len(p2.group_nodes(gid)) == 2
    # Adopted gangs are retired like launched ones.
    p2.terminate_node_group(gid)
    assert api.alive() == ["ray-other-x-0"]
