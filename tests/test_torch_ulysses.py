"""The port's Ulysses attention (``ray_tpu_torch.ops.ulysses``) against the
JAX package's per-shard ``ulysses_attention``, under a ``jax.shard_map``
the test builds over CPU devices (``check_vma=False``), as
``tests/test_torch_ring_attention.py`` does. The port runs on virtual
ranks of a CPU mesh, where flash attention takes its plain version.

Tolerances: f32 outputs and gradients within 1e-5 (rtol and atol; below
128 tokens both sides run the plain attention, summed in another order),
and at 128 tokens and more, where the port's flash runs its plain kernel
version and the reference its interpreted kernel, 1e-4.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ray_tpu.ops import ulysses as JU  # noqa: E402
from ray_tpu_torch.models.llama import xla_attention  # noqa: E402
from ray_tpu_torch.ops import ulysses as TU  # noqa: E402
from ray_tpu_torch.ops.ring_attention import shard_sequence  # noqa: E402
from ray_tpu_torch.parallel import make_mesh  # noqa: E402

TOL = 1e-5
SPEC = JP(None, "sp", None, None)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B=2, S=64, H=4, Hkv=4, D=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32))


def _jax_fn(n, causal):
    mesh = JMesh(np.asarray(jax.devices()[:n]), ("sp",))
    return jax.shard_map(
        partial(JU.ulysses_attention, causal=causal, axis_name="sp"),
        mesh=mesh, in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False)


def _mesh(n):
    return make_mesh({"sp": n}, devices=["cpu"] * n)


@pytest.mark.parametrize("n,H,Hkv,S,tol", [
    (2, 4, 4, 64, TOL), (4, 4, 4, 64, TOL), (2, 4, 2, 64, TOL),
    (4, 8, 4, 64, TOL), (2, 4, 2, 256, 1e-4)])
def test_ulysses_matches_reference(n, H, Hkv, S, tol):
    q, k, v = _qkv(n + H + Hkv, S=S, H=H, Hkv=Hkv)
    want = np.asarray(_jax_fn(n, True)(*(jnp.asarray(a) for a in (q, k, v))))
    got = TU.ulysses_attention_global(
        *(torch.from_numpy(a) for a in (q, k, v)), _mesh(n), seq_axis="sp")
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_ulysses_grads_match_reference():
    q, k, v = _qkv(1, H=4, Hkv=2)
    w = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    fn = _jax_fn(2, True)
    jg = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = TU.ulysses_attention_global(tq, tk, tv, _mesh(2), seq_axis="sp")
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=TOL)


def test_reshard_round_trips_and_places_heads():
    """[n, B, S/n, H, D] -> [n, B, S, H/n, D]: rank r holds head chunk r
    of the whole sequence; and back."""
    n, B, S, H, D = 4, 2, 16, 8, 3
    x = torch.arange(B * S * H * D, dtype=torch.float32).reshape(B, S, H, D)
    heads = TU._to_heads(shard_sequence(x, n))
    for r in range(n):
        assert torch.equal(heads[r], x[:, :, r * 2:(r + 1) * 2])
    assert torch.equal(TU._to_sequence(heads), shard_sequence(x, n))


def test_divisibility_error_keeps_the_reference_text():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, H=6, Hkv=2))
    with pytest.raises(ValueError, match="must divide n_heads=6 and "
                                         "n_kv_heads=2"):
        TU.ulysses_attention_global(q, k, v, _mesh(4), seq_axis="sp")


def test_unbound_is_exact_local_attention():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, H=4, Hkv=2))
    want = xla_attention(q, torch.repeat_interleave(k, 2, 2),
                         torch.repeat_interleave(v, 2, 2))
    np.testing.assert_allclose(TU.ulysses_attention(q, k, v).numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)
    one = TU.ulysses_attention_global(q, k, v, _mesh(1), seq_axis="sp")
    assert torch.equal(one, TU.ulysses_attention(q, k, v))


def test_context_parallel_attention_impl_switch():
    from ray_tpu_torch.parallel import context_parallel_attention

    q, k, v = (torch.from_numpy(a) for a in _qkv(5))
    mesh = make_mesh({"seq": 2}, devices=["cpu"] * 2)
    ring = context_parallel_attention(mesh, impl="ring")(q, k, v)
    uly = context_parallel_attention(mesh, impl="ulysses")(q, k, v)
    np.testing.assert_allclose(ring.numpy(), uly.numpy(), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="expected 'ring' or 'ulysses'"):
        context_parallel_attention(mesh, impl="nope")
