"""The port's ring attention (``ray_tpu_torch.ops.ring_attention``) against
the JAX package's per-shard ``ring_attention``.

The reference's own global wrapper does not run on this host's jax (its
``shard_map(..., check_rep=False)``), so the test builds the
``jax.shard_map`` over 4 CPU devices itself, with ``check_vma=False``,
around the JAX package's per-shard function; nothing in the JAX package
changes. The port runs on 4 virtual ranks of a CPU mesh, where C1's
route takes C1's plain version.

Tolerances: f32 outputs and gradients within 1e-5 (rtol and atol; the
online softmax sums in the same order, the products in another); bf16
within 2e-2 absolute (each side rounds P to bf16 before P.V, from f32
scores summed in a different order, so a probability can round to the
neighbouring bf16 value: one bf16 ulp of the output's magnitude); the
port's two routes (the rotation and C1's split-phase hops) equal bit for
bit.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ray_tpu.models.llama import xla_attention as j_xla  # noqa: E402
from ray_tpu.ops import ring_attention as JR  # noqa: E402
from ray_tpu_torch.models.llama import xla_attention  # noqa: E402
from ray_tpu_torch.ops import ring_attention as TR  # noqa: E402
from ray_tpu_torch.parallel import make_mesh  # noqa: E402
from ray_tpu_torch.util.collective import ring as R  # noqa: E402

N = 4
TOL = 1e-5
BF16_TOL = 2e-2
SPEC = JP(None, "sp", None, None)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B=2, S=64, H=4, D=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _jax_ring(q, k, v, causal, impl, dtype=jnp.float32):
    mesh = JMesh(np.asarray(jax.devices()[:N]), ("sp",))
    fn = jax.shard_map(
        partial(JR.ring_attention, causal=causal, axis_name="sp", impl=impl),
        mesh=mesh, in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False)
    out = fn(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


def _mesh(n=N):
    return make_mesh({"sp": n}, devices=["cpu"] * n)


def _port(q, k, v, causal, impl, dtype=torch.float32):
    out = TR.ring_attention_global(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), _mesh(),
        causal=causal, seq_axis="sp", impl=impl)
    return out.float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["lax", "pallas_interpret"])
def test_ring_matches_reference_f32(causal, impl):
    q, k, v = _qkv(0)
    want = _jax_ring(q, k, v, causal, impl)
    np.testing.assert_allclose(_port(q, k, v, causal, impl), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_reference_bf16(causal):
    q, k, v = _qkv(1)
    want = _jax_ring(q, k, v, causal, "lax", jnp.bfloat16)
    got = _port(q, k, v, causal, "lax", torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_split_phase_route_equals_rotation_bitwise(dtype, causal):
    """C1's split-phase hops (plain on the CPU) move the same bytes into
    the same block math as the rotation route."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, S=128))
    mesh = _mesh()
    sq, sk, sv = (TR.shard_sequence(t, N) for t in (q, k, v))
    lax = TR.ring_attention(sq, sk, sv, causal, "sp", "lax", mesh=mesh)
    for impl in ("pallas", "pallas_interpret"):
        split = TR.ring_attention(sq, sk, sv, causal, "sp", impl, mesh=mesh)
        assert torch.equal(split, lax), impl


def test_ring_matches_full_attention():
    """Against the plain full-sequence attention of both packages."""
    q, k, v = _qkv(3)
    full = j_xla(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    got = _port(q, k, v, True, "lax")
    np.testing.assert_allclose(got, np.asarray(full), rtol=TOL, atol=TOL)
    mine = xla_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got, mine.numpy(), rtol=TOL, atol=TOL)


def test_ring_grads_match_reference():
    q, k, v = _qkv(4)
    mesh = JMesh(np.asarray(jax.devices()[:N]), ("sp",))
    fn = jax.shard_map(
        partial(JR.ring_attention, causal=True, axis_name="sp", impl="lax"),
        mesh=mesh, in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False)
    w = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = TR.ring_attention_global(tq, tk, tv, _mesh(), seq_axis="sp")
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=TOL)


def test_unbound_is_exact_local_attention():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6))
    want = xla_attention(q, k, v, causal=True)
    assert torch.equal(TR.ring_attention(q, k, v), want)
    one = make_mesh({"sp": 1}, devices=["cpu"])
    assert torch.equal(TR.ring_attention_global(q, k, v, one,
                                                seq_axis="sp"), want)
    jo = JR.ring_attention(*(jnp.asarray(a) for a in _qkv(6)), causal=True)
    np.testing.assert_allclose(want.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)


def test_split_phase_route_refuses_autograd():
    """C1's route is forward only, like pallas_call: it raises under
    autograd rather than detaching."""
    q, k, v = (TR.shard_sequence(torch.from_numpy(a), N) for a in _qkv(7))
    q.requires_grad_(True)
    for impl in ("cuda", "pallas", "pallas_interpret"):
        with pytest.raises(RuntimeError, match="forward only"):
            TR.ring_attention(q, k, v, True, "sp", impl, mesh=_mesh())
    with torch.no_grad():
        TR.ring_attention(q, k, v, True, "sp", "pallas", mesh=_mesh())


def test_cuda_route_launches_c1_or_raises():
    """impl='cuda' asks for the kernel: on a CPU tensor C1's wrapper
    raises (no fallback); 'auto' on a CPU tensor is the rotation."""
    q, k, v = (TR.shard_sequence(torch.from_numpy(a), N) for a in _qkv(8))
    with pytest.raises(ValueError, match="CUDA"):
        TR.ring_attention(q, k, v, True, "sp", "cuda", mesh=_mesh())
    auto = TR.ring_attention(q, k, v, True, "sp", "auto", mesh=_mesh())
    assert torch.equal(auto, TR.ring_attention(q, k, v, True, "sp", "lax",
                                               mesh=_mesh()))


def test_c1_plain_hops_counted_two_per_step(monkeypatch):
    """The split-phase route issues one hop of K and one of V at each of
    the n steps: 2n hops a call, as the reference's scan does."""
    calls = []
    plain = R.ring_permute_plain
    monkeypatch.setattr(R, "ring_permute_plain",
                        lambda x: calls.append(x.shape) or plain(x))
    q, k, v = (TR.shard_sequence(torch.from_numpy(a), N) for a in _qkv(9))
    TR.ring_attention(q, k, v, True, "sp", "pallas", mesh=_mesh())
    assert len(calls) == 2 * N
    assert all(s[0] == N and s[2] == R.LANES for s in calls)


def test_shapes_are_checked():
    q = torch.zeros((2, 1, 16, 2, 8))
    with pytest.raises(ValueError, match="rank-major"):
        TR.ring_attention(q, q, q, True, "sp", "lax", mesh=_mesh())
    with pytest.raises(ValueError, match="does not split"):
        TR.shard_sequence(torch.zeros((1, 10, 2, 8)), N)
    with pytest.raises(ValueError, match="impl must be"):
        TR.ring_attention(*(TR.shard_sequence(torch.zeros(1, 8, 2, 8), N),)
                          * 3, True, "sp", "nope", mesh=_mesh())


def test_model_attn_impl_ring_is_exact_local_attention():
    from ray_tpu_torch.models import llama as TL

    cfg = TL.LlamaConfig.tiny(dtype=torch.float32)
    p = TL.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 16))).long()
    got = TL.forward(p, toks, TL.LlamaConfig.tiny(dtype=torch.float32,
                                                  attn_impl="ring"))
    assert torch.equal(got, TL.forward(p, toks, cfg))
