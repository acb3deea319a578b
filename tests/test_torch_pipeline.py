"""The port's pipeline schedule (``ray_tpu_torch.parallel.pipeline``)
against the JAX package's ``pipeline_apply`` on ``make_mesh({"pipe": 4,
"data": 2})`` over the 8 CPU devices; the port's runs on 8 virtual ranks
of a CPU mesh. The reference's own pipeline tests (``tests/test_moe_
pipeline.py``) are the model: stacked tanh-linear stages.

Tolerances: outputs within 1e-5 and gradients within 1e-4 relative /
1e-5 absolute (f32; the stages' products summed in another order), the
reference test's own bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ray_tpu.parallel import pipeline as JP  # noqa: E402
from ray_tpu_torch.parallel import make_mesh  # noqa: E402
from ray_tpu_torch.parallel import pipeline as TP  # noqa: E402

P_, W = 4, 16


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stages(seed, width=W):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(P_, width, width) / width ** 0.5).astype(
                np.float32),
            "b": (rng.randn(P_, width) * 0.01).astype(np.float32)}


def _j_stage(p, x):
    return jax.nn.tanh(x @ p["w"] + p["b"])


def _t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _meshes():
    return (j_make_mesh({"pipe": 4, "data": 2}),
            make_mesh({"pipe": 4, "data": 2}, devices=["cpu"] * 8))


@pytest.mark.parametrize("M,MB", [(8, 4), (4, 2), (1, 3)])
def test_pipeline_matches_reference(M, MB):
    params = _stages(M)
    x = np.random.RandomState(1).randn(M * MB, W).astype(np.float32)
    jmesh, tmesh = _meshes()
    want = JP.pipeline_apply(_j_stage, jax.tree.map(jnp.asarray, params),
                             JP.microbatch(jnp.asarray(x), M), jmesh)
    got = TP.pipeline_apply(_t_stage, {k: torch.from_numpy(v) for k, v in
                                       params.items()},
                            TP.microbatch(torch.from_numpy(x), M), tmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    seq = torch.from_numpy(x)
    for i in range(P_):
        seq = _t_stage({k: torch.from_numpy(v[i]) for k, v in
                        params.items()}, seq)
    np.testing.assert_allclose(TP.unmicrobatch(got).numpy(), seq.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_grads_match_reference():
    M, MB = 4, 2
    params = _stages(7, 8)
    x = np.random.RandomState(2).randn(M * MB, 8).astype(np.float32)
    jmesh, tmesh = _meshes()
    jg = jax.grad(lambda p: jnp.sum(JP.pipeline_apply(
        _j_stage, p, JP.microbatch(jnp.asarray(x), M), jmesh) ** 2))(
        jax.tree.map(jnp.asarray, params))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TP.pipeline_apply(_t_stage, tp, TP.microbatch(xt, M), tmesh)
    (out ** 2).sum().backward()
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-5)
    assert xt.grad is not None and float(xt.grad.abs().max()) > 0


class _Counted(torch.autograd.Function):
    """The identity, counting its forward and backward calls."""
    calls = {"fwd": 0, "bwd": 0}

    @staticmethod
    def forward(ctx, x):
        _Counted.calls["fwd"] += 1
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _Counted.calls["bwd"] += 1
        return g


@pytest.mark.parametrize("M", [8, 4, 1])
def test_every_stage_runs_every_tick(M):
    """Forward: (M + P - 1) * P stage calls, bubbles included, as the
    reference's scan runs them. Backward: every call of every tick but
    the last, and the last stage's call of the last tick: P * (M + P - 2)
    + 1 (the counts chip_smoke.py gates B1-B3 on)."""
    _Counted.calls.update(fwd=0, bwd=0)
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in _stages(3).items()}
    x = torch.from_numpy(np.random.RandomState(4).randn(M, 2, W).astype(
        np.float32))

    def stage(p, h):
        return _Counted.apply(_t_stage(p, h))

    out = TP.pipeline_apply(stage, params, x, _meshes()[1])
    assert _Counted.calls["fwd"] == (M + P_ - 1) * P_
    out.sum().backward()
    assert _Counted.calls["bwd"] == P_ * (M + P_ - 2) + 1


def test_microbatch_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="not divisible by M=3"):
        TP.microbatch(torch.zeros((8, 2)), 3)
    x = torch.arange(24.).reshape(12, 2)
    assert torch.equal(TP.unmicrobatch(TP.microbatch(x, 4)), x)
