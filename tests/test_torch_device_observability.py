"""The device-facing gauges and the device-trace bracket on the port
(``observability.device``, ``observability.profiling.capture_tpu_trace``,
the worker's ``tpu_profile`` RPC, the raylet's ``kind="tpu_profile"`` and
``util.state.tpu_profile``).

This host has no card, so what runs here is what a process without a
CUDA context does: the sampler reads nothing and never creates a context
(no ``libcuda`` in a fresh process's maps after sampling), and the
bracket skips with a reason. What a context changes is driven with
``torch.cuda``'s queries stood in: the gauges' values, and the refusal of
a second bracket while one is open. One cluster for the module; every
wait has a timeout.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.observability import device as D  # noqa: E402
from ray_tpu_torch.observability import profiling as P  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_sampling_never_creates_a_cuda_context():
    """A fresh process that registers the sampler, samples, flushes the
    metric records, asks its device spec and opens the bracket maps no
    ``libcuda`` and holds no context afterwards."""
    code = (
        "import torch\n"
        "from ray_tpu_torch.observability import chipspec, device, "
        "profiling\n"
        "from ray_tpu_torch.util import metrics\n"
        "device.ensure_sampler_registered()\n"
        "n = device.sample_device_metrics()\n"
        "metrics.snapshot_records()\n"
        "spec = chipspec.local_spec().measurement\n"
        "skipped = 'skipped' in profiling.capture_tpu_trace(0.01)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(n, spec, skipped, torch.cuda.is_initialized(), "
        "'libcuda' in maps)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "cpu", "True", "False", "False"]


class _FakeCuda:
    """``torch.cuda``'s queries of a process holding a context on one
    H100 (the sampler reads nothing else)."""

    def __init__(self, monkeypatch, used=12345, total=85 * 2**30):
        for name, fn in {
                "is_initialized": lambda: True,
                "device_count": lambda: 1,
                "current_device": lambda: 0,
                "memory_reserved": lambda i=None: 2 * used,
                "memory_allocated": lambda i=None: used,
                "get_device_name": lambda i=None: "NVIDIA H100 80GB HBM3",
                "mem_get_info": lambda i=None: (total - 2 * used, total),
                "synchronize": lambda i=None: None}.items():
            monkeypatch.setattr(torch.cuda, name, fn)


def _gauge(name, **tags):
    g = D._device_gauges()[name]
    return g._data[g._tag_tuple(tags)]


def test_gauges_read_the_allocator_and_the_card(monkeypatch):
    _FakeCuda(monkeypatch, used=12345, total=85 * 2**30)
    assert D.sample_device_metrics() == 1
    kind = "NVIDIA H100 80GB HBM3"
    assert _gauge("used", device="0", kind=kind) == 12345.0
    assert _gauge("total", device="0", kind=kind) == float(85 * 2**30)
    assert _gauge("count", kind=kind, platform="gpu") == 1.0


def test_device_spec_follows_the_context(monkeypatch):
    from ray_tpu_torch.observability import chipspec

    _FakeCuda(monkeypatch)
    spec = chipspec.local_spec()
    assert spec.spec == "h100" and spec.measurement == "gpu"


def test_bracket_skips_without_a_context():
    reply = P.capture_tpu_trace(0.05)
    assert set(reply) == {"skipped"}
    assert "no CUDA context" in reply["skipped"]


def test_second_bracket_is_refused(monkeypatch, tmp_path):
    """Kineto takes one profiler per process: while a bracket is open, a
    second one raises, and the first still runs to its end."""
    _FakeCuda(monkeypatch)
    opened, release = threading.Event(), threading.Event()

    class _Window:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            opened.set()
            release.wait(30)
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text('{"traceEvents": []}')

    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _Window)
    monkeypatch.setattr(P, "_prime_cupti", lambda *a: True)
    first = {}
    t = threading.Thread(target=lambda: first.update(
        P.capture_tpu_trace(0.0, trace_dir=str(tmp_path / "trace"))))
    t.start()
    try:
        assert opened.wait(30)
        with pytest.raises(RuntimeError, match="already open"):
            P.capture_tpu_trace(0.0)
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive() and not P.window_open.is_set()
    assert first["kernel_events"] == 0
    assert first["artifact"] == str(tmp_path / "trace" / "trace.json")


def test_trace_kernel_events_reads_kernel_records(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(
        '{"traceEvents": ['
        '{"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel<bf16>"},'
        '{"ph": "X", "cat": "kernel", "name": "elementwise"},'
        '{"ph": "X", "cat": "cpu_op", "name": "flash_fwd"},'
        '{"ph": "i", "cat": "kernel", "name": "flash_fwd"}]}')
    assert len(P.trace_kernel_events(str(path))) == 2
    assert len(P.trace_kernel_events(str(path), "flash_fwd")) == 1


# ------------------------------------------------------------ cluster tier

@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                              object_store_memory=128 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Probe:
    def pid(self):
        return os.getpid()

    def hold_bracket(self):
        """Stand in a context and an open bracket in this process."""
        import torch as t

        from ray_tpu_torch.observability import profiling

        t.cuda.is_initialized = lambda: True
        profiling._trace_lock.acquire()
        return True


def test_tpu_profile_on_an_actor_skips_with_a_reason(cluster):
    from ray_tpu_torch.util import state

    actor = _Probe.remote()
    pid = ray_tpu_torch.get(actor.pid.remote(), timeout=60)
    reply = state.tpu_profile(actor_id=actor._actor_id.hex(), duration=0.1)
    assert "no CUDA context" in reply["skipped"]
    assert reply["pid"] == pid and "artifact" not in reply
    with pytest.raises(ValueError, match="exactly one"):
        state.tpu_profile()


def test_raylet_forwards_tpu_profile(cluster):
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    actor = _Probe.remote()
    pid = ray_tpu_torch.get(actor.pid.remote(), timeout=60)
    worker_id = state._resolve_actor_worker(actor._actor_id.hex())
    row = state._worker_row(worker_id)
    raylet = global_worker()._raylet_for_node(row["node_id"])
    replies = raylet.call("profile_worker",
                          worker_id=bytes.fromhex(worker_id),
                          duration_s=0.1, kind="tpu_profile", timeout=60)
    assert replies[worker_id]["pid"] == pid
    assert "skipped" in replies[worker_id]


def test_open_bracket_gives_an_error_reply(cluster):
    from ray_tpu_torch.util import state

    actor = _Probe.remote()
    assert ray_tpu_torch.get(actor.hold_bracket.remote(), timeout=60)
    reply = state.tpu_profile(actor_id=actor._actor_id.hex(), duration=0.1)
    assert "already open" in reply["error"]
    ray_tpu_torch.kill(actor)
