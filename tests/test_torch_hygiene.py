"""Boundaries of the PyTorch/CUDA port.

- ``ray_tpu_torch/`` and ``chip_smoke.py`` import neither JAX nor anything
  of the JAX package ``ray_tpu`` (the port keeps its own copy of what it
  needs). Note that ``ray_tpu_torch`` itself starts with ``ray_tpu``: the
  check is on the module name ``ray_tpu`` and the prefix ``ray_tpu.``.
- No string in them names a JAX-package module (``"ray_tpu._private.…"``),
  as a ``-m`` entry point would; and a live port cluster starts only
  ``ray_tpu_torch.`` processes.
- Entry points called without a device run on the card; on a host without
  one they raise instead of running on the CPU.
"""

import ast
import os
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
            for alias in node.names:        # from x import jax-like names
                yield node.lineno, f"{node.module}.{alias.name}"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "ray_tpu"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"llama.py", "attention.py", "engine.py", "deployment.py",
            "fused_loss.py", "train_step.py", "ring.py", "group.py",
            "zero.py", "chip_smoke.py", "kv_cache.py", "spec.py",
            "config.py", "control.py", "metrics.py", "tracing.py",
            "accounting.py", "serve.py", "transfer.py", "prefill.py",
            "decode.py", "ids.py", "resources.py", "gpu.py",
            "accelerator.py", "exceptions.py", "serialization.py",
            "object_ref.py", "task_spec.py", "rpc.py", "object_store.py",
            "native_store.py", "reference_count.py",
            "scheduling_policy.py", "gcs_server.py", "raylet.py",
            "node.py", "worker_main.py", "fate_share.py",
            "memory_monitor.py", "log_monitor.py", "usage_stats.py",
            "worker.py", "remote_function.py", "actor.py",
            "runtime_context.py", "scheduling_strategies.py",
            "placement_group.py", "autoscale.py", "multiplex.py",
            "handle.py", "replica.py", "router.py", "controller.py",
            "api.py", "state.py", "app.py", "trainer.py",
            "cuda_backend.py", "torch_backend.py", "backend.py",
            "checkpoint.py", "sharded_checkpoint.py", "storage.py",
            "session.py", "worker_group.py", "backend_executor.py",
            "goodput.py", "train.py", "collective.py", "util.py",
            "types.py", "process_ring.py", "base_collective_group.py",
            "shm_collective_group.py", "torch_collective_group.py",
            "cuda_collective_group.py"} <= names
    assert (ROOT / "ray_tpu_torch/_private/csrc/arena_store.cpp").exists()


def test_every_config_setting_has_a_reader():
    """A setting is defined only where a module of the port reads it (an
    attribute ``GlobalConfig.<name>`` or the name as a string, or, for the
    engine's ``"serve_" + name`` lookups, the rest of the name)."""
    from ray_tpu_torch._private.config import _REGISTRY

    attrs, strings = set(), set()
    for path in PORT_FILES:
        if path.name == "config.py" and path.parent.name == "_private":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                attrs.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                strings.add(node.value)
    unread = [name for name in _REGISTRY
              if name not in attrs and name not in strings
              and name.removeprefix("serve_") not in strings]
    assert not unread, f"settings no module reads: {unread}"


# A dotted module path of the JAX package: what ``-m`` would run.
_JAX_PACKAGE_MODULE = re.compile(r"ray_tpu(\.[A-Za-z_]\w*)+")


def _jax_package_module_strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and _JAX_PACKAGE_MODULE.fullmatch(node.value.strip())):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_package_module_named_as_an_entry_point(path):
    """A string naming a JAX-package module (``"ray_tpu._private.raylet"``
    after ``"-m"``) would start the reference's daemons from the port."""
    bad = list(_jax_package_module_strings(path))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_entry_point_rule_tells_the_packages_apart(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        'cmd = [exe, "-m", "ray_tpu._private.worker_main"]\n'
        'ok = [exe, "-m", "ray_tpu_torch._private.worker_main"]\n'
        'prefix = "ray_tpu."\n'
        'doc = "the reference\'s ray_tpu._private.raylet, for comparison"\n')
    assert list(_jax_package_module_strings(probe)) == [
        (1, "ray_tpu._private.worker_main")]


def _descendants(pid):
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return [a.decode() for a in f.read().split(b"\0") if a]
    except OSError:
        return None


def test_port_cluster_spawns_only_port_processes():
    """Every process a port cluster starts (GCS, raylet, task and actor
    workers, and Serve's controller, router and replicas) runs a
    ``ray_tpu_torch.`` module, and none loads JAX or the JAX package; a
    worker that touches no tensor loads no torch."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import build_routed_llm_app

    ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                       object_store_memory=64 * 1024 * 1024)
    try:
        handle = serve.run(build_routed_llm_app(
            LlamaConfig.tiny(dtype=torch.float32),
            {"num_slots": 1, "max_seq_len": 32, "prefill_buckets": (8,)},
            num_replicas=1, quantize="bf16", device="cpu"), name="hyg")
        out = handle.remote({"prompt": [1, 2, 3],
                             "max_tokens": 2}).result(timeout=120)
        assert out["num_tokens"] == 2

        @serve.deployment
        def replica_modules(_):
            return sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "ray_tpu"))

        assert serve.run(replica_modules.bind(), name="mods").remote(
            None).result(timeout=60) == []

        @ray_tpu_torch.remote
        def modules():
            return sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "ray_tpu", "torch"))

        @ray_tpu_torch.remote
        class Probe:
            def modules(self):
                return sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "ray_tpu"))

        actor = Probe.remote()
        assert ray_tpu_torch.get([modules.remote(), actor.modules.remote()],
                                 timeout=60) == [[], []]
        # A collective group's coordinator actor runs in a worker of the
        # port: its process is a ray_tpu_torch. module.
        from ray_tpu_torch.util import state
        from ray_tpu_torch.util.collective.util import \
            get_or_create_coordinator

        hub = get_or_create_coordinator("hygiene", 1)
        assert ray_tpu_torch.get(hub.put.remote("k", 1), timeout=60)
        wid = next(a["worker_id"] for a in state.list_actors()
                   if a["name"] == "collective_group:hygiene")
        pid = next(w["pid"] for w in state.list_workers()
                   if w["worker_id"] == wid)
        cmd = _cmdline(pid)
        assert cmd[cmd.index("-m") + 1].startswith("ray_tpu_torch."), cmd
        cmds = [c for c in map(_cmdline, _descendants(os.getpid()))
                if c is not None]
        assert len(cmds) >= 3                  # GCS, raylet, workers
        for cmd in cmds:
            assert "-m" in cmd, cmd
            module = cmd[cmd.index("-m") + 1]
            assert module.startswith("ray_tpu_torch."), cmd
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.models.llama")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("ray_tpu_torch.models.llama")
    assert not _forbidden("torch")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")


def test_init_params_default_device_raises():
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(LlamaConfig.tiny())


def test_engine_default_device_raises():
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    _no_cuda()
    params = init_params(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(params, LlamaConfig.tiny())


def test_server_default_device_raises():
    from ray_tpu_torch.serve.llm import LLMServer

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServer()


def test_create_train_state_default_device_raises():
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.parallel import create_train_state

    _no_cuda()
    params = init_params(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(params)


def test_build_train_step_default_device_raises():
    from ray_tpu_torch.parallel import build_train_step

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_step(lambda params, batch: None)


def test_ring_group_default_device_raises():
    from ray_tpu_torch.util.collective import RingGroup

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        RingGroup(4)


def test_cuda_collective_group_default_device_raises():
    """A ``cuda`` group made without ``device=`` runs on the card, and
    raises on a host without one before any rendezvous."""
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective.collective_group \
        .cuda_collective_group import CudaGroup

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaGroup(2, 0, "no-card")
    with pytest.raises(RuntimeError, match="CUDA"):
        col.init_collective_group(2, 0, backend="cuda", group_name="no-card")
    assert not col.is_group_initialized("no-card")


def test_run_pod_training_default_device_raises():
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.cuda_backend import run_pod_training

    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pod_training(model_config=LlamaConfig.tiny(), steps=1)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrapper's launch; the public
    function gives it the plain version instead, by device alone."""
    from ray_tpu_torch.ops.attention import flash_fwd_cuda

    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q)


TRAIN_SETTINGS = ("train_goodput_instrumentation", "train_steps_buffer_size",
                  "train_straggler_threshold", "train_straggler_window",
                  "train_stall_heartbeats", "train_stall_min_timeout_s",
                  "train_stall_check_interval_s")


def test_train_settings_are_the_reference_s():
    """The seven ``train_*`` settings came with their readers (the
    goodput ledger, the GCS step matrix and its watchdog), with the
    reference's types and defaults."""
    from ray_tpu._private.config import _REGISTRY as REF
    from ray_tpu_torch._private.config import _REGISTRY

    for name in TRAIN_SETTINGS:
        assert name in _REGISTRY, name
        assert (_REGISTRY[name].type, _REGISTRY[name].default) == \
            (REF[name].type, REF[name].default), name


def test_train_imports_are_lazy():
    """Importing Train, its backends and its observability builds no
    kernel, imports no triton and touches no CUDA: a kernel is built
    inside the call that launches it."""
    import subprocess

    probe = (
        "import sys, torch\n"
        "import ray_tpu_torch.train as t\n"
        "from ray_tpu_torch.train import (cuda_backend, torch_backend,\n"
        "    sharded_checkpoint, storage, trainer)\n"
        "from ray_tpu_torch.observability import goodput, train\n"
        "from ray_tpu_torch.ops import _build\n"
        "assert 'triton' not in sys.modules\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not _build._loaded\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'ray_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_trainer_workers_lease_gpus_and_are_port_processes():
    """On a CPU cluster with two faked cards: a ``use_gpu=True`` worker
    holds a GPU lease (its ``metadata()`` reports the lease's ids and the
    raylet set ``CUDA_VISIBLE_DEVICES``), every process the node spawned
    for the trainer's workers runs a ``ray_tpu_torch.`` module, and a GPU
    gang of two raises, naming the ZeRO-across-processes slice."""
    import ray_tpu_torch
    from ray_tpu_torch.accelerators import gpu as G
    from ray_tpu_torch.train import (
        CudaTrainer, ScalingConfig, TrainingFailedError,
    )
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup
    from ray_tpu_torch.train.cuda_backend import pod_train_loop

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(G.FAKE_GPUS_ENV, "2")
        mp.setenv(G.FAKE_GPU_TYPE_ENV, "H100")
        ray_tpu_torch.init(num_cpus=4, object_store_memory=64 * 1024 * 1024)
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU") == 2
        group = WorkerGroup(1, ScalingConfig(num_workers=1, use_gpu=True)
                            .worker_resources())
        meta = group.metadata()
        assert len(meta[0]["gpu_ids"]) == 1
        visible = group.execute(
            lambda: os.environ.get("CUDA_VISIBLE_DEVICES"))
        assert visible == [str(meta[0]["gpu_ids"][0])]
        assert ray_tpu_torch.available_resources().get("GPU") == 1
        cmds = [c for c in map(_cmdline, _descendants(os.getpid()))
                if c is not None]
        assert any(str(meta[0]["pid"]) == str(p)
                   for p in _descendants(os.getpid()))
        for cmd in cmds:
            assert "-m" in cmd, cmd
            assert cmd[cmd.index("-m") + 1].startswith("ray_tpu_torch."), cmd
        group.shutdown()

        with pytest.raises(TrainingFailedError,
                           match="ZeRO-across-processes slice"):
            CudaTrainer(pod_train_loop, scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True)).fit()
    finally:
        ray_tpu_torch.shutdown()
