"""NVIDIA cards as the port's ``GPU`` resource (``accelerators/gpu.py``,
the raylet's GPU pool, the worker's lease guard), mirroring the
reference's ``tests/test_tpu_detection.py``.

Unit cases first (detection with ``nvidia-smi`` mocked, the type parse,
quantities, ``CUDA_VISIBLE_DEVICES``, the reused-worker guard with
``torch.cuda.is_initialized`` mocked); then the port's GPU id assignment
held against the reference's TPU chip assignment on one sequence of
demands; then one cluster with two faked cards.
"""

import os
import subprocess
import sys
import time
import types

import pytest

import ray_tpu_torch
from ray_tpu_torch.accelerators import gpu as G


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (G.FAKE_GPUS_ENV, G.FAKE_GPU_TYPE_ENV,
                G.CUDA_VISIBLE_DEVICES_ENV):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(G, "_bound_devices", None)


def _fake_smi(monkeypatch, stdout, returncode=0):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if stdout is None:
            raise FileNotFoundError("nvidia-smi")
        return subprocess.CompletedProcess(cmd, returncode, stdout, "")

    monkeypatch.setattr(G.subprocess, "run", run)
    return calls


H100X2 = "0, NVIDIA H100 80GB HBM3\n1, NVIDIA H100 80GB HBM3\n"


# ------------------------------------------------------------- detection

def test_count_from_fake_env(monkeypatch):
    calls = _fake_smi(monkeypatch, H100X2)
    monkeypatch.setenv(G.FAKE_GPUS_ENV, "3")
    monkeypatch.setenv(G.CUDA_VISIBLE_DEVICES_ENV, "0")
    assert G.GPUAcceleratorManager.get_current_node_num_accelerators() == 3
    assert calls == []


@pytest.mark.parametrize("visible, n", [("0", 1), ("0,1", 2), ("", 0),
                                        ("1, 3 ,5", 3)])
def test_count_from_cuda_visible_devices(monkeypatch, visible, n):
    calls = _fake_smi(monkeypatch, H100X2)
    monkeypatch.setenv(G.CUDA_VISIBLE_DEVICES_ENV, visible)
    assert G.GPUAcceleratorManager.get_current_node_num_accelerators() == n
    assert calls == []


def test_count_from_nvidia_smi(monkeypatch):
    calls = _fake_smi(monkeypatch, H100X2)
    assert G.GPUAcceleratorManager.get_current_node_num_accelerators() == 2
    assert calls == [G.NVIDIA_SMI_QUERY]


@pytest.mark.parametrize("stdout, rc", [(None, 0), ("", 0), (H100X2, 9)],
                         ids=["missing", "empty", "failing"])
def test_count_nothing_found(monkeypatch, stdout, rc):
    _fake_smi(monkeypatch, stdout, rc)
    assert G.GPUAcceleratorManager.get_current_node_num_accelerators() == 0
    assert G.GPUAcceleratorManager.get_current_node_accelerator_type() is None
    assert G.GPUAcceleratorManager.get_current_node_extra_resources() == {}


def test_type_and_extra_resources(monkeypatch):
    _fake_smi(monkeypatch, H100X2)
    assert G.GPUAcceleratorManager.get_current_node_accelerator_type() == \
        "H100"
    assert G.GPUAcceleratorManager.get_current_node_extra_resources() == \
        {"GPU-H100": 2.0}


def test_type_follows_visible_devices(monkeypatch):
    _fake_smi(monkeypatch, "0, NVIDIA A100-SXM4-80GB\n"
                           "1, NVIDIA H100 80GB HBM3\n")
    assert G.GPUAcceleratorManager.get_current_node_accelerator_type() \
        is None                                         # mixed node
    monkeypatch.setenv(G.CUDA_VISIBLE_DEVICES_ENV, "1")
    assert G.GPUAcceleratorManager.get_current_node_accelerator_type() == \
        "H100"


def test_fake_type(monkeypatch):
    calls = _fake_smi(monkeypatch, H100X2)
    monkeypatch.setenv(G.FAKE_GPUS_ENV, "2")
    assert G.GPUAcceleratorManager.get_current_node_accelerator_type() is None
    monkeypatch.setenv(G.FAKE_GPU_TYPE_ENV, "H100")
    assert G.GPUAcceleratorManager.get_current_node_extra_resources() == \
        {"GPU-H100": 2.0}
    assert calls == []


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100"),
    ("NVIDIA A100-SXM4-80GB", "A100"), ("Tesla V100-SXM2-16GB", "V100"),
    ("NVIDIA L4", "L4"), ("NVIDIA GeForce RTX 4090", "RTX4090"),
    ("NVIDIA", None)])
def test_type_parse(name, want):
    assert G.parse_gpu_type(name) == want


def test_detection_imports_no_torch():
    code = ("import sys; from ray_tpu_torch._private.node import "
            "default_resources; default_resources(num_cpus=1); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ------------------------------------------------------------ quantities

@pytest.mark.parametrize("qty", [0, 1, 2, 3, 8, 0.5, 0.25, 0.001])
def test_valid_gpu_requests(qty):
    ok, msg = G.GPUAcceleratorManager.validate_resource_request_quantity(qty)
    assert ok and msg is None


@pytest.mark.parametrize("qty", [1.5, 2.25, -1, -0.5])
def test_invalid_gpu_requests(qty):
    ok, msg = G.GPUAcceleratorManager.validate_resource_request_quantity(qty)
    assert not ok and "GPU" in msg


def test_invalid_quantity_rejected_at_submit():
    from ray_tpu_torch._private.worker import _resources_from_options

    with pytest.raises(ValueError, match="fraction"):
        _resources_from_options({"num_gpus": 1.5})
    res = _resources_from_options({"num_gpus": 0.5,
                                   "accelerator_type": "H100"})
    assert res.get("GPU") == 0.5 and res.get("GPU-H100") > 0


@pytest.mark.parametrize("make", ["task", "actor"])
def test_num_tpus_raises_naming_num_gpus(make):
    def f():
        return 1

    target = f if make == "task" else type("A", (), {})
    with pytest.raises(ValueError, match="num_gpus"):
        ray_tpu_torch.remote(num_tpus=1)(target)


# ------------------------------------------------------------ visibility

@pytest.mark.parametrize("ids, want", [(["0"], "0"), (["0", "1"], "0,1"),
                                       ([], "")])
def test_visible_devices(monkeypatch, ids, want):
    G.GPUAcceleratorManager.set_current_process_visible_accelerator_ids(ids)
    assert os.environ[G.CUDA_VISIBLE_DEVICES_ENV] == want


def _mock_cuda(monkeypatch, initialized):
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: initialized[0]))
    monkeypatch.setitem(sys.modules, "torch", fake)


def test_lease_sets_devices_while_no_context(monkeypatch):
    initialized = [False]
    _mock_cuda(monkeypatch, initialized)
    G.note_lease([1])
    assert os.environ[G.CUDA_VISIBLE_DEVICES_ENV] == "1"
    G.note_lease([])
    assert os.environ[G.CUDA_VISIBLE_DEVICES_ENV] == ""
    G.note_lease([0, 1])
    assert os.environ[G.CUDA_VISIBLE_DEVICES_ENV] == "0,1"


def test_reused_worker_with_context_refuses_other_devices(monkeypatch):
    """A worker whose CUDA context was made under "0" runs further leases
    of "0" and leases without GPUs, and raises for any other set."""
    initialized = [False]
    _mock_cuda(monkeypatch, initialized)
    G.note_lease([0])
    initialized[0] = True               # the task touched CUDA
    G.note_lease([0])
    G.note_lease([])
    assert os.environ[G.CUDA_VISIBLE_DEVICES_ENV] == "0"
    for ids in ([1], [0, 1]):
        with pytest.raises(RuntimeError, match="CUDA_VISIBLE_DEVICES='0'"):
            G.note_lease(ids)
    assert os.environ[G.CUDA_VISIBLE_DEVICES_ENV] == "0"


def test_context_made_without_devices_refuses_a_gpu_lease(monkeypatch):
    initialized = [False]
    _mock_cuda(monkeypatch, initialized)
    G.note_lease([])
    initialized[0] = True
    with pytest.raises(RuntimeError, match="CUDA_VISIBLE_DEVICES=''"):
        G.note_lease([0])


def test_worker_turns_the_guard_into_a_task_error(monkeypatch):
    """The worker's task path returns the guard's error as the task's
    application error instead of running the body."""
    from ray_tpu_torch._private import serialization, worker as W

    ran = []

    class Stub:
        _cancelled_tasks = set()
        _ctx = W._TaskContext()

        def _mark_log_task(self, spec):
            pass

        def _load_function(self, h):
            ran.append(h)

    def refuse(ids):
        raise RuntimeError("context under another device set")

    monkeypatch.setattr(G, "note_lease", refuse)
    spec = types.SimpleNamespace(task_id=types.SimpleNamespace(
        binary=lambda: b"t"), name="f")
    reply = W.Worker._execute_task(Stub(), spec, [1])
    err, _ = serialization.deserialize_error(reply["app_error"])
    assert isinstance(err, RuntimeError) and "device set" in str(err)
    assert ran == []


# ------------------------------------- GPU ids against the reference's TPU

def _pools():
    from ray_tpu._private import raylet as RR
    from ray_tpu._private.resources import ResourceSet as RRS
    from ray_tpu_torch._private import raylet as TR
    from ray_tpu_torch._private.resources import ResourceSet as TRS

    ref = object.__new__(RR.Raylet)
    ref._free_tpu_chips, ref._frac_chip, ref._frac_users = [0, 1, 2, 3], None, 0
    ref._bundles = {}
    port = object.__new__(TR.Raylet)
    port._free_gpus, port._frac_gpu, port._frac_users = [0, 1, 2, 3], None, 0
    port._bundles = {}
    return ((ref, RRS, "TPU", "_free_tpu_chips", ref._take_tpu_chips,
             ref._release_tpu_chips, "tpu_chips"),
            (port, TRS, "GPU", "_free_gpus", port._take_gpus,
             port._release_gpus, "gpu_ids"))


def _drive(side):
    """One sequence of whole, fractional and placement-group demands;
    returns every grant and the pool after each step."""
    raylet, RS, name, pool, take, release, key = side
    pg = b"\x07" * 18
    out, held = [], {}

    def grant(tag, demand):
        ids = take(RS(demand))
        held[tag] = (RS(demand), ids)
        out.append((tag, ids, sorted(getattr(raylet, pool))))

    def free(tag):
        demand, ids = held.pop(tag)
        release(demand, ids)
        out.append(("-" + tag, sorted(getattr(raylet, pool))))

    grant("a", {name: 1})
    grant("h1", {name: 0.5})
    grant("h2", {name: 0.5})
    grant("b", {name: 2})
    free("h1")
    grant("q", {name: 0.25})
    free("a")
    free("h2")
    free("q")
    # A bundle of two reserves its ids; leases inside it draw from them.
    bundle = RS({name: 2})
    raylet._bundles[(pg, 0)] = {"resources": bundle, "committed": False,
                                key: take(bundle)}
    grant("in_pg", {f"{name}_group_0_{pg.hex()}": 1})
    grant("in_pg2", {f"{name}_group_{pg.hex()}": 1})
    free("in_pg")
    free("b")
    grant("c", {name: 1})
    grant("d", {name: 0.5})
    out.append(("bundle", sorted(raylet._bundles[(pg, 0)][key])))
    return out


def test_gpu_ids_follow_the_reference_tpu_chip_assignment():
    pytest.importorskip("jax")
    ref, port = _pools()
    assert _drive(port) == _drive(ref)


# ---------------------------------------------------- a node of two cards

@pytest.fixture(scope="module")
def two_gpus():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(G.FAKE_GPUS_ENV, "2")
        mp.setenv(G.FAKE_GPU_TYPE_ENV, "H100")
        info = ray_tpu_torch.init(num_cpus=4,
                                  object_store_memory=128 * 1024 * 1024,
                                  ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_gpus=1)
class Holder:
    def devices(self):
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_gpu_ids())


@ray_tpu_torch.remote(num_gpus=0.5)
def half():
    time.sleep(0.5)
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            ray_tpu_torch.get_gpu_ids())


@ray_tpu_torch.remote
def no_gpu():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            ray_tpu_torch.get_gpu_ids())


def test_detected_resources(two_gpus):
    res = ray_tpu_torch.cluster_resources()
    assert res["GPU"] == 2 and res["GPU-H100"] == 2


def test_whole_gpus_one_each_then_pend(two_gpus):
    a, b = Holder.remote(), Holder.remote()
    got = sorted(ray_tpu_torch.get([a.devices.remote(), b.devices.remote()],
                                   timeout=60))
    assert got == [("0", [0]), ("1", [1])]
    c = Holder.remote()
    ref = c.devices.remote()
    ready, _ = ray_tpu_torch.wait([ref], timeout=3)
    assert ready == []
    ray_tpu_torch.kill(a)
    assert ray_tpu_torch.get(ref, timeout=60) == got[0]
    for h in (b, c):
        ray_tpu_torch.kill(h)


def test_fractions_share_one_gpu_and_no_lease_sees_none(two_gpus):
    _wait_free(2)
    got = ray_tpu_torch.get([half.remote(), half.remote()], timeout=60)
    assert got[0] == got[1] and got[0][1] in ([0], [1])
    assert got[0][0] == str(got[0][1][0])
    assert ray_tpu_torch.get(no_gpu.remote(), timeout=60) == ("", [])


def test_accelerator_type_demand(two_gpus):
    _wait_free(2)
    h = Holder.options(accelerator_type="H100").remote()
    assert ray_tpu_torch.get(h.devices.remote(), timeout=60)[1] in ([0], [1])
    ray_tpu_torch.kill(h)


def test_placement_group_bundle_gets_its_own_gpu(two_gpus):
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group,
    )
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    _wait_free(2)
    pg = placement_group([{"GPU": 1, "CPU": 1}])
    assert pg.wait(30)
    inside = Holder.options(scheduling_strategy=(
        PlacementGroupSchedulingStrategy(pg, 0))).remote()
    outside = Holder.remote()
    got_in = ray_tpu_torch.get(inside.devices.remote(), timeout=60)
    got_out = ray_tpu_torch.get(outside.devices.remote(), timeout=60)
    assert {got_in[0], got_out[0]} == {"0", "1"}
    assert got_in[1] == [int(got_in[0])]
    for h in (inside, outside):
        ray_tpu_torch.kill(h)
    remove_placement_group(pg)


def _wait_free(n):
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources().get("GPU", 0) < n:
        assert time.monotonic() < deadline, "GPUs were not released"
        time.sleep(0.1)
