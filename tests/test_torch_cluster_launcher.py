"""The cluster launcher's YAML and gang autoscaling on the port
(``ray_tpu_torch.autoscaler.config``, ``gpu_pod_provider``,
``pod_autoscaler``): configs without a ``tpu`` key validate as the JAX
package validates them, bad ones raise the same error; the ``gpu``
shorthand's expansion, table-driven; a TPU word raises naming the slice;
and the reference's ``tests/test_cluster_launcher.py`` cases on GPU gangs
(all-or-nothing rollback, a head-resource demand launching a whole gang
and retiring it once idle). Cards are faked; every wait has a timeout.
"""

import copy
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators import gpu as G
from ray_tpu_torch.autoscaler.config import (
    ClusterConfigError, gpu_gang_shape, load_cluster_config,
    validate_cluster_config,
)

BASE = {"cluster_name": "x", "provider": {"type": "fake"},
        "available_node_types": {"a": {"resources": {}}}}

# The reference's test_config_validation configs without a tpu key, and
# more of each error its validator raises.
CONFIGS = {
    "no_name_or_provider": {"max_workers": 4},
    "unknown_top_key": {**BASE, "bogus_key": 1},
    "unknown_type_key": {**BASE, "available_node_types": {
        "a": {"bad_field": 1}}},
    "not_a_mapping": ["cluster_name"],
    "name_not_str": {**BASE, "cluster_name": 3},
    "no_provider_type": {**BASE, "provider": {}},
    "no_node_types": {**BASE, "available_node_types": {}},
    "type_not_mapping": {**BASE, "available_node_types": {"a": 1}},
    "resources_not_mapping": {**BASE, "available_node_types": {
        "a": {"resources": [1]}}},
    "bad_gang_size": {**BASE, "available_node_types": {
        "a": {"node_config": {"gang_size": 0}}}},
    "unknown_head_type": {**BASE, "head_node_type": "b"},
    "negative_max_workers": {**BASE, "max_workers": -1},
    "cpu_worker": {
        "cluster_name": "tpu-demo", "max_workers": 12,
        "provider": {"type": "fake"},
        "available_node_types": {"cpu.worker": {
            "resources": {"CPU": 4}, "min_workers": 0, "max_workers": 4}},
        "idle_timeout_minutes": 1},
    "defaults": {**BASE},
    "gang_and_labels": {**BASE, "head_node_type": "a",
                        "available_node_types": {
                            "a": {"resources": {"CPU": 2}},
                            "b": {"node_config": {"gang_size": 3},
                                  "labels": {"zone": "z1"},
                                  "max_workers": 2}},
                        "setup_commands": ["true"]},
    "kuberay": {**BASE, "provider": {"type": "kuberay",
                                     "namespace": "ns1"}},
}


def _outcome(validate, error, cfg):
    try:
        return ("ok", validate(copy.deepcopy(cfg)))
    except error as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_validates_as_the_jax_package(name):
    from ray_tpu.autoscaler import config as ref

    want = _outcome(ref.validate_cluster_config, ref.ClusterConfigError,
                    CONFIGS[name])
    got = _outcome(validate_cluster_config, ClusterConfigError, CONFIGS[name])
    assert got == want


def test_yaml_loads_and_expands(tmp_path):
    cfg_file = tmp_path / "cluster.yaml"
    cfg_file.write_text("""
cluster_name: gpu-demo
max_workers: 12
provider:
  type: fake
available_node_types:
  cpu.worker:
    resources: {CPU: 4}
    min_workers: 0
    max_workers: 4
  gpu.h100x16:
    node_config: {gpu: H100-16, cpus_per_host: 2}
    min_workers: 0
    max_workers: 2
idle_timeout_minutes: 1
""")
    cfg = load_cluster_config(str(cfg_file))
    gpu_type = cfg["available_node_types"]["gpu.h100x16"]
    assert gpu_type["gang_size"] == 2          # H100-16 = 2 hosts x 8
    assert gpu_type["resources"] == {"CPU": 2, "GPU": 8, "GPU-H100": 8.0}
    assert gpu_type["head_resources"] == {"GPU-H100-16-head": 1}
    assert cfg["available_node_types"]["cpu.worker"]["gang_size"] == 1
    with pytest.raises(ClusterConfigError, match="not found"):
        load_cluster_config(str(tmp_path / "missing.yaml"))


# ------------------------------------------------------- the gpu shorthand
SHAPES = [
    # node_config, (gang_size, per-host resources, head resources)
    ({"gpu": "H100-1"}, (1, {"CPU": 8, "GPU": 1, "GPU-H100": 1.0},
                         {"GPU-H100-1-head": 1})),
    ({"gpu": "H100-8"}, (1, {"CPU": 8, "GPU": 8, "GPU-H100": 8.0},
                         {"GPU-H100-8-head": 1})),
    ({"gpu": "H100-16"}, (2, {"CPU": 8, "GPU": 8, "GPU-H100": 8.0},
                          {"GPU-H100-16-head": 1})),
    ({"gpu": "A100-32", "cpus_per_host": 4},
     (4, {"CPU": 4, "GPU": 8, "GPU-A100": 8.0}, {"GPU-A100-32-head": 1})),
    ({"gpu": "H100-16", "gpu_hosts": 4, "gpus_per_host": 4},
     (4, {"CPU": 8, "GPU": 4, "GPU-H100": 4.0}, {"GPU-H100-16-head": 1})),
    ({"gpu": "H100-16", "gpus_per_host": 2},
     (8, {"CPU": 8, "GPU": 2, "GPU-H100": 2.0}, {"GPU-H100-16-head": 1})),
    ({"gpu": "L4-4", "gpu_hosts": 2},
     (2, {"CPU": 8, "GPU": 2, "GPU-L4": 2.0}, {"GPU-L4-4-head": 1})),
]


@pytest.mark.parametrize("node_config, want", SHAPES,
                         ids=[s[0]["gpu"] + "-" + str(i)
                              for i, s in enumerate(SHAPES)])
def test_gpu_shorthand_expands(node_config, want):
    cfg = validate_cluster_config({
        **BASE, "available_node_types": {"g": {"node_config": node_config}}})
    spec = cfg["available_node_types"]["g"]
    assert (spec["gang_size"], spec["resources"],
            spec["head_resources"]) == want
    assert spec["gpu_type"] == node_config["gpu"]


@pytest.mark.parametrize("gpu, kw", [
    ("H100", {}), ("H100-0", {}), ("H100-12", {}), ("-8", {}),
    ("H100-16", {"gpus_per_host": 3}), ("H100-8", {"hosts": 3}),
])
def test_bad_gpu_shapes_raise(gpu, kw):
    with pytest.raises(ClusterConfigError):
        gpu_gang_shape(gpu, **kw)


def test_gpu_gang_shape_fallback_rule():
    """Up to 8 cards on one host, hosts of 8 above: the rule the
    reference's tpu_slice_shape applies to unknown TPU types, at 8."""
    assert gpu_gang_shape("H100-4") == (1, 4)
    assert gpu_gang_shape("H100-8") == (1, 8)
    assert gpu_gang_shape("H100-64") == (8, 8)
    assert gpu_gang_shape("x-16", hosts=3, gpus_per_host=2) == (3, 2)


@pytest.mark.parametrize("cfg, word", [
    ({**BASE, "available_node_types": {"t": {"node_config": {
        "tpu": "v5e-16"}}}}, "node_config.tpu"),
    ({**BASE, "provider": {"type": "gcp_tpu"}}, "gcp_tpu"),
    ({**BASE, "available_node_types": {"t": {"resources": {"TPU": 4}}}},
     "TPU resource"),
])
def test_tpu_words_raise_naming_the_slice(cfg, word):
    with pytest.raises(ClusterConfigError) as err:
        validate_cluster_config(cfg)
    assert word in str(err.value)
    assert "autoscaler slice" in str(err.value)
    assert "GPU" in str(err.value) or "gpu" in str(err.value)


# ----------------------------------------------------------------- gangs
@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setenv(G.FAKE_GPUS_ENV, "8")
    monkeypatch.setenv(G.FAKE_GPU_TYPE_ENV, "H100")
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024)
    yield info
    ray_tpu_torch.shutdown()


@pytest.mark.timeout(120)
def test_gang_rollback_on_partial_failure(monkeypatch, cluster):
    """All-or-nothing: if host 2 of a gang fails to start, host 1 is torn
    down and the provider reports no group."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.autoscaler.gpu_pod_provider import \
        SubprocessPodProvider

    w = global_worker()
    provider = SubprocessPodProvider(w.gcs_addr, w.session_dir)
    real_node = node_mod.Node
    calls = {"n": 0, "started": []}

    class FlakyNode:
        def __new__(cls, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("host 2 failed to boot")
            node = real_node(*args, **kwargs)
            calls["started"].append(node)
            return node

    monkeypatch.setattr(node_mod, "Node", FlakyNode)
    try:
        with pytest.raises(RuntimeError, match="host 2"):
            provider.create_node_group(
                "gpu.fake", {"resources": {"CPU": 1, "GPU": 8}},
                gang_size=2)
        assert provider.node_groups() == []
        assert provider.non_terminated_nodes() == []
        assert all(p.poll() is not None for node in calls["started"]
                   for p in [node._raylet_proc])
    finally:
        monkeypatch.setattr(node_mod, "Node", real_node)
        provider.shutdown()


@pytest.mark.timeout(150)
def test_gpu_gang_scales_up_on_head_demand_and_down_on_idle(cluster):
    """The YAML path end to end: a ``GPU-H100-16-head`` demand launches
    both hosts of the gang atomically, each with its 8 cards; idle past
    the timeout retires the gang."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.autoscaler.config import make_provider
    from ray_tpu_torch.autoscaler.pod_autoscaler import PodAutoscaler

    cfg = validate_cluster_config({
        "cluster_name": "gangs",
        "max_workers": 8,
        "provider": {"type": "subprocess"},
        "available_node_types": {
            "gpu.h100x16": {
                "node_config": {"gpu": "H100-16", "cpus_per_host": 1},
                "min_workers": 0, "max_workers": 1,
            },
        },
        "idle_timeout_minutes": 0.05,   # 3s
    })
    w = global_worker()
    provider = make_provider(cfg, w.gcs_addr, w.session_dir)
    scaler = PodAutoscaler(w.gcs_addr, provider, cfg)
    try:
        @ray_tpu_torch.remote(resources={"GPU-H100-16-head": 1})
        def on_gang_head():
            return ray_tpu_torch.get_runtime_context().get_node_id()

        ref = on_gang_head.remote()

        launched = 0
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and launched == 0:
            time.sleep(1.0)
            launched = scaler.update()["launched"]
        assert launched == 1, "gang demand never launched a gang"
        groups = provider.node_groups()
        assert len(groups) == 1
        assert len(provider.group_nodes(groups[0])) == 2  # both hosts

        node_id = ray_tpu_torch.get(ref, timeout=90)
        internal = {provider.internal_node_id(p).hex()
                    for p in provider.group_nodes(groups[0])}
        assert node_id in internal
        assert ray_tpu_torch.cluster_resources().get("GPU") == 16

        # The whole gang comes down together once idle.
        terminated = 0
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and terminated == 0:
            time.sleep(1.0)
            terminated = scaler.update()["terminated"]
        assert terminated == 1, "idle gang never scaled down"
        assert provider.node_groups() == []
        assert provider.non_terminated_nodes() == []
    finally:
        provider.shutdown()
