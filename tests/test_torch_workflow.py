"""Durable workflows on the port (``ray_tpu_torch.workflow``): every case
of the reference's own ``tests/test_workflow.py``, asserting what it
asserts there, on the port's cluster; the same workflow run by each
package, each in a subprocess of its own, leaving the same files, the
same status records and equal step outputs; steps that take ``remote``
options; and the slice as a whole: a three-step workflow whose middle
step leases the (faked) GPU and runs the attention forward, held to the
JAX package's kernel (interpret mode), resumed after its last step fails
without running the GPU step again. One cluster for the module; every
wait has a timeout.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=1,
                              object_store_memory=128 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


def _wait_for(pred, timeout=30.0, period=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return pred()


@pytest.fixture(autouse=True)
def _wf_storage(tmp_path):
    workflow.init(str(tmp_path / "wf"))
    yield


@workflow.step
def double(x):
    return 2 * x


@workflow.step
def add(a, b):
    return a + b


def test_dag_runs_and_returns(cluster):
    out = add.step(double.step(3), double.step(4)).run("basic")
    assert out == 14
    assert workflow.get_status("basic") == "SUCCEEDED"
    assert workflow.get_output("basic") == 14


def test_steps_checkpoint_and_replay(cluster, tmp_path):
    marker = str(tmp_path / "runs")
    os.makedirs(marker)

    @workflow.step
    def tracked(x):
        import time

        open(os.path.join(marker, f"run_{time.time_ns()}"), "w").close()
        return x + 1

    dag = tracked.step(10)
    assert dag.run("replay") == 11
    assert len(os.listdir(marker)) == 1
    # Re-running the same workflow id replays from storage: no re-execution.
    dag2 = tracked.step(10)
    assert dag2.run("replay") == 11
    assert len(os.listdir(marker)) == 1


def test_resume_after_failure(cluster, tmp_path):
    marker = str(tmp_path / "m")
    os.makedirs(marker)

    @workflow.step
    def flaky(x):
        if not os.path.exists(os.path.join(marker, "ok")):
            raise RuntimeError("first attempt dies")
        return x * 100

    @workflow.step
    def stable(x):
        open(os.path.join(marker, f"stable_{x}"), "w").close()
        return x

    dag = flaky.step(add.step(stable.step(1), stable.step(2)))
    with pytest.raises(Exception):
        dag.run("resumable")
    assert workflow.get_status("resumable") == "FAILED"
    # The completed prefix (stable x2 + add) is checkpointed.
    assert len([f for f in os.listdir(marker)
                if f.startswith("stable")]) == 2

    open(os.path.join(marker, "ok"), "w").close()
    out = workflow.resume("resumable")
    assert out == 300
    # stable steps replayed from storage, not re-executed.
    assert len([f for f in os.listdir(marker)
                if f.startswith("stable")]) == 2
    assert workflow.get_status("resumable") == "SUCCEEDED"


def test_list_all(cluster):
    double.step(1).run("wf_a")
    double.step(2).run("wf_b")
    listed = {w["workflow_id"]: w["status"] for w in workflow.list_all()}
    assert listed == {"wf_a": "SUCCEEDED", "wf_b": "SUCCEEDED"}


def test_step_options_retries_and_catch(cluster, tmp_path):
    """max_retries re-executes a flaky step; catch_exceptions checkpoints
    (result, err) pairs (reference: workflow.options)."""
    marker = tmp_path / "flaky_tries"

    @workflow.step(max_retries=3)
    def flaky():
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            raise RuntimeError("transient")
        return "recovered"

    assert flaky.step().run("wf_retry") == "recovered"
    assert int(marker.read_text()) == 3

    @workflow.step
    def always_fails():
        raise ValueError("boom")

    @workflow.step
    def handle(pair):
        result, err = pair
        return f"handled:{type(err).__name__}" if err else result

    out = handle.step(
        always_fails.step().options(catch_exceptions=True)).run("wf_catch")
    assert out == "handled:ValueError"
    assert workflow.get_status("wf_catch") == "SUCCEEDED"

    # Without catch_exceptions the workflow fails.
    with pytest.raises(Exception):
        handle.step(always_fails.step()).run("wf_nocatch")
    assert workflow.get_status("wf_nocatch") == "FAILED"


def test_step_takes_remote_options(cluster):
    """A step runs as a task with its ``remote`` options: ``num_gpus=1``
    leases the card, ``.options`` copies (the original keeps its own),
    and an option ``remote`` does not take is refused."""

    @workflow.step(num_gpus=1)
    def on_card():
        return ray_tpu_torch.get_gpu_ids(), os.environ["CUDA_VISIBLE_DEVICES"]

    @workflow.step
    def on_cpu():
        return ray_tpu_torch.get_gpu_ids()

    assert on_card.step().run("wf_gpu") == ([0], "0")
    cpu = on_cpu.step()
    gpu = cpu.options(num_gpus=1)
    assert cpu.ray_options == {} and gpu.ray_options == {"num_gpus": 1}
    assert gpu.run("wf_gpu_opt") == [0]
    assert cpu.run("wf_cpu") == []
    with pytest.raises(ValueError, match="num_gpus instead"):
        workflow.step(num_tpus=1)


# ------------------------------------------------------------------ events
def test_event_step_options_keeps_listener():
    """wait_for_event(...).options(...) must stay an EventStep — Step's
    copy semantics would drop the listener and crash at execution."""
    from ray_tpu_torch.workflow import EventStep

    ev = workflow.wait_for_event("approved", timeout=3.0)
    tuned = ev.options(max_retries=2, catch_exceptions=True)
    assert isinstance(tuned, EventStep)
    assert tuned.listener is ev.listener
    assert tuned.timeout == 3.0
    assert tuned.max_retries == 2 and tuned.catch_exceptions
    # untouched original (copy semantics preserved)
    assert ev.max_retries == 0 and not ev.catch_exceptions


def test_wait_for_event_delivers_and_checkpoints(cluster, tmp_path):
    """A workflow parks on wait_for_event until the HTTP provider
    delivers; after success the event payload is CHECKPOINTED — resume
    replays it even with the event file gone."""
    import urllib.request

    @workflow.step
    def combine(evt, y):
        return f"{evt['order']}-{y}"

    provider = workflow.HTTPEventProvider(
        storage_dir=workflow._storage()).start()
    try:
        dag = combine.step(workflow.wait_for_event("payment"), 7)
        out = {}

        def run_wf():
            out["result"] = dag.run("wf_evt")

        t = threading.Thread(target=run_wf)
        t.start()
        # Parked on the event: the workflow is RUNNING and cannot end
        # before the event is delivered.
        assert _wait_for(lambda: workflow.get_status("wf_evt") == "RUNNING")
        assert t.is_alive()

        req = urllib.request.Request(
            f"http://127.0.0.1:{provider.port}/event/wf_evt/payment",
            data=json.dumps({"order": "A17"}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["delivered"]
        t.join(timeout=60)
        assert not t.is_alive()
        assert out["result"] == "A17-7"

        # GET reads the delivered event back.
        with urllib.request.urlopen(
                f"http://127.0.0.1:{provider.port}/event/wf_evt/payment",
                timeout=10) as resp:
            assert json.loads(resp.read())["payload"] == {"order": "A17"}

        # Durability: delete the event file; resume must REPLAY the
        # checkpointed payload, not re-wait.
        evt_file = os.path.join(workflow._storage(), "wf_evt", "events",
                                "payment.json")
        os.remove(evt_file)
        assert workflow.resume("wf_evt") == "A17-7"
    finally:
        provider.stop()


def test_wait_for_event_timeout(cluster):
    @workflow.step
    def use(evt):
        return evt

    dag = use.step(workflow.wait_for_event("never", timeout=0.5))
    with pytest.raises(Exception, match="never"):
        dag.run("wf_evt_to")
    assert workflow.get_status("wf_evt_to") == "FAILED"


def test_event_checkpointed_ack_fires_after_durable(cluster):
    acks = []

    class AckListener(workflow.FileEventListener):
        def event_checkpointed(self, event):
            acks.append(event)

    @workflow.step
    def use(evt):
        return evt["n"]

    from ray_tpu_torch.workflow.events import deliver_event

    deliver_event(workflow._storage(), "wf_ack", "go", {"n": 5})
    dag = use.step(workflow.wait_for_event(lambda: AckListener("go")))
    assert dag.run("wf_ack") == 5
    assert acks == [{"n": 5}]


# --------------------------------------------- the JAX package's storage
_PARITY_SCRIPT = """
import os, sys
import {pkg} as rt
from {pkg} import workflow
from {pkg}.workflow.events import deliver_event

rt.init(num_cpus=2, {no_device}=0, object_store_memory=64 * 1024 * 1024)
workflow.init(sys.argv[1])
marker = sys.argv[2]


@workflow.step
def double(x):
    return 2 * x


@workflow.step
def add(a, b):
    return a + b


@workflow.step
def flaky(x):
    if not os.path.exists(marker):
        raise RuntimeError("first attempt dies")
    return {{"out": x * 100, "items": [x, "s", None]}}


@workflow.step
def fails():
    raise ValueError("boom")


@workflow.step
def handle(pair):
    return pair[1] is not None


add.step(double.step(3), double.step(4)).run("basic")
try:
    flaky.step(add.step(double.step(1), double.step(2))).run("resumable")
except Exception:
    pass
open(marker, "w").close()
workflow.resume("resumable")
handle.step(fails.step().options(catch_exceptions=True)).run("caught")
@workflow.step
def use(evt):
    return evt["n"] + 1


deliver_event(workflow._storage(), "evt", "go", {{"n": 5}})
use.step(workflow.wait_for_event("go")).run("evt")
print("LISTED", sorted((w["workflow_id"], w["status"])
                       for w in workflow.list_all()))
rt.shutdown()
"""


def _plain(value):
    """A step output with each exception as its type's name and args
    (exceptions do not compare equal)."""
    if isinstance(value, BaseException):
        return type(value).__name__, value.args
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _storage_tree(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            files[os.path.relpath(path, root)] = path
    return files


def test_storage_matches_the_jax_package(tmp_path):
    """The same workflows run by each package, each in a subprocess of
    its own, leave the same file names, the same status records (less
    their time stamps) and equal step outputs."""
    pytest.importorskip("jax")
    procs = {}
    for pkg, no_device in (("ray_tpu", "num_tpus"),
                           ("ray_tpu_torch", "num_gpus")):
        d = tmp_path / pkg
        d.mkdir()
        script = d / "wf.py"
        script.write_text(_PARITY_SCRIPT.format(pkg=pkg,
                                                no_device=no_device))
        procs[pkg] = subprocess.Popen(
            [sys.executable, str(script), str(d / "store"),
             str(d / "marker")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    outs = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, (pkg, err[-3000:])
        outs[pkg] = [ln for ln in out.splitlines() if ln.startswith("LISTED")]
    assert outs["ray_tpu"] == outs["ray_tpu_torch"] and outs["ray_tpu"]
    ref = _storage_tree(tmp_path / "ray_tpu" / "store")
    port = _storage_tree(tmp_path / "ray_tpu_torch" / "store")
    assert sorted(ref) == sorted(port)
    assert any(name.endswith("step_flaky_0.pkl") for name in ref)
    for name in ref:
        if name.endswith("status.json"):
            want, got = (json.load(open(f[name])) for f in (ref, port))
            assert want.pop("ts") > 0 and got.pop("ts") > 0
            assert got == want
        elif name.endswith(".json"):                 # a delivered event
            assert json.load(open(port[name])) == json.load(open(ref[name]))
        elif os.path.basename(name).startswith("step_"):
            with open(ref[name], "rb") as f:
                want = pickle.load(f)
            with open(port[name], "rb") as f:
                got = pickle.load(f)
            assert _plain(got) == _plain(want), name


# ------------------------------------------------ the slice, on the CPU
def _attn_inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((1, 128, 2, 64)).astype(np.float32)
            for _ in range(3)]


def test_gpu_step_resumes_from_its_checkpoint(cluster, tmp_path,
                                              monkeypatch):
    """The slice as a whole: make inputs (CPU) -> attention forward on a
    ``num_gpus=1`` step (the lease's card, here faked and the plain
    version on the CPU) -> a last step that fails on its first run. The
    status goes RUNNING -> FAILED -> RUNNING -> SUCCEEDED, resume does
    not run the GPU step again, and the output equals a direct call of
    the three functions and the JAX package's kernel in interpret
    mode."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.ops import attention as jattn

    marker = str(tmp_path / "marks")
    os.makedirs(marker)

    def make(seed):
        import torch

        return [torch.from_numpy(a) for a in _attn_inputs(seed)]

    def attend(qkv, marker):
        import time

        from ray_tpu_torch.ops.attention import flash_attention

        with open(os.path.join(marker, f"attend_{time.time_ns()}"), "w") as f:
            f.write(json.dumps(ray_tpu_torch.get_gpu_ids()))
        q, k, v = qkv
        return flash_attention(q, k, v, causal=True).cpu()

    def finish(o, marker, storage):
        with open(os.path.join(storage, "gpu_wf", "status.json")) as f:
            seen = json.load(f)["status"]
        with open(os.path.join(marker, f"finish_{seen}"), "a") as f:
            f.write("x")
        if not os.path.exists(os.path.join(marker, "ok")):
            raise RuntimeError("the last step fails on its first run")
        return {"o": o, "sum": float(o.double().sum())}

    dag = workflow.step(finish).step(
        workflow.step(attend).options(num_gpus=1).step(
            workflow.step(make).step(0), marker),
        marker, workflow._storage())
    with pytest.raises(Exception, match="first run"):
        dag.run("gpu_wf")
    assert workflow.get_status("gpu_wf") == "FAILED"
    open(os.path.join(marker, "ok"), "w").close()
    out = workflow.resume("gpu_wf")
    assert workflow.get_status("gpu_wf") == "SUCCEEDED"
    runs = sorted(n for n in os.listdir(marker) if n.startswith("attend_"))
    assert len(runs) == 1
    with open(os.path.join(marker, runs[0])) as f:
        assert json.load(f) == [0]
    assert sorted(n for n in os.listdir(marker)
                  if n.startswith("finish_")) == ["finish_RUNNING"]
    with open(os.path.join(marker, "finish_RUNNING")) as f:
        assert f.read() == "xx"

    import torch

    direct = finish(attend(make(0), str(tmp_path)), marker,
                    workflow._storage())
    assert torch.equal(out["o"], direct["o"]) and out["sum"] == direct["sum"]
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)
    q, k, v = (jnp.asarray(a) for a in _attn_inputs(0))
    want, _ = jattn._flash_fwd(q, k, v, True)
    np.testing.assert_allclose(out["o"].numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    assert workflow.get_output("gpu_wf")["sum"] == out["sum"]
