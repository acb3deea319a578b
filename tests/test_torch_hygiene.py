"""Boundaries of the PyTorch/CUDA port.

- ``ray_tpu_torch/`` and ``chip_smoke.py`` import neither JAX nor anything
  of the JAX package ``ray_tpu`` (the port keeps its own copy of what it
  needs). Note that ``ray_tpu_torch`` itself starts with ``ray_tpu``: the
  check is on the module name ``ray_tpu`` and the prefix ``ray_tpu.``.
- Entry points called without a device run on the card; on a host without
  one they raise instead of running on the CPU.
"""

import ast
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
            "decode.py"} <= names


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


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrapper's launch; the public
    function gives it the plain version instead, by device alone."""
    from ray_tpu_torch.ops.attention import flash_fwd_cuda

    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q)
