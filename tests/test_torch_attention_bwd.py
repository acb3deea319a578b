"""The gradient of the port's flash attention (``ray_tpu_torch.ops.attention``)
against the JAX package's backward kernels.

The JAX side runs ``jax.grad`` through its ``flash_attention`` with
``FORCE_PALLAS_INTERPRET`` set, so its Pallas backward kernels (dK/dV and
dQ) run in interpret mode on the CPU, as ``tests/test_ops.py`` runs them;
the port's side takes its autograd Function, whose backward on CPU
tensors is the plain version of kernels B2 and B3. Inputs and the
weighting of the output come from numpy.

Tolerances: f32 1e-4 (rtol and atol; summation order only). bf16: both
sides round P and dS to bf16 at the same places, so they differ only
where a summation-order difference flips a rounding: each element is held
to 2**-7 of its value (one bf16 ulp) plus 2**-8 of the largest gradient
element.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu_torch.models.llama import xla_attention  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402

F32_TOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test runs, restored after it: these
    tests share the host with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, S, H=2, D=64, B=1):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    return (q, k, v), w


def _jax_grads(arrs, w, causal, jdtype):
    def loss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal)
        return jnp.sum(o.astype(jnp.float32) * w)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jdtype) for a in arrs))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_grads(arrs, w, causal, tdtype, fn=tattn.flash_attention):
    ts = [torch.from_numpy(a).to(tdtype).requires_grad_(True) for a in arrs]
    out = fn(*ts, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _close(got, ref, dtype, what):
    for g, r, name in zip(got, ref, "qkv"):
        if dtype == "f32":
            np.testing.assert_allclose(g, r, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"{what}: d{name}")
        else:
            np.testing.assert_allclose(
                g, r, rtol=2.0 ** -7, atol=2.0 ** -8 * np.abs(r).max(),
                err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("S", [128, 200])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grads_match_jax_backward_kernels(S, dtype, interpret):
    """dQ, dK, dV against the Pallas backward kernels (interpret mode),
    including a ragged length the port masks by index."""
    arrs, w = _inputs(S, S)
    jd, td = DTYPES[dtype]
    ref = _jax_grads(arrs, w, True, jd)
    got = _torch_grads(arrs, w, True, td)
    _close(got, ref, dtype, f"S={S} {dtype}")


def test_short_sequence_grads_take_plain_attention(interpret):
    """Below 128 tokens autograd runs through plain attention on both
    sides (the reference's XLA vjp), and no kernel is involved."""
    arrs, w = _inputs(5, 64, B=2)
    before = (tattn.flash_bwd_dkv_cuda.launches,
              tattn.flash_bwd_dq_cuda.launches)
    ref = _jax_grads(arrs, w, True, jnp.float32)
    got = _torch_grads(arrs, w, True, torch.float32)
    _close(got, ref, "f32", "S=64")
    assert (tattn.flash_bwd_dkv_cuda.launches,
            tattn.flash_bwd_dq_cuda.launches) == before


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_is_the_gradient_of_attention(causal):
    """In f32 the plain backward equals autograd through plain attention
    (no rounding in f32, so only summation order differs)."""
    arrs, w = _inputs(11, 256, B=2)
    got = _torch_grads(arrs, w, causal, torch.float32)
    ref = _torch_grads(arrs, w, causal, torch.float32, fn=xla_attention)
    _close(got, ref, "f32", f"causal={causal}")


def test_strided_output_gradient():
    """A gradient that reaches attention as a strided view gives the same
    result as its contiguous copy."""
    arrs, _ = _inputs(13, 160)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = tattn.flash_attention(*ts, causal=True)
    g = torch.from_numpy(np.random.RandomState(14).standard_normal(
        (1, 2, 160, 64)).astype(np.float32)).transpose(1, 2)
    assert not g.is_contiguous()
    strided = torch.autograd.grad(out, ts, g, retain_graph=True)
    dense = torch.autograd.grad(out, ts, g.contiguous())
    for a, b in zip(strided, dense):
        assert torch.equal(a, b)


def test_masked_pairs_are_zero_by_index():
    """P is set to zero by index above the diagonal, not derived from
    exp(-1e30 - LSE): rows whose LSE is -1e30 (the value of a row with no
    visible key) would give P = exp(0) = 1 on every masked pair that way.
    With such rows before 150 and dO zero from row 150 on, keys from 150
    on, which only rows from 150 on can see, must get exactly zero dK
    and dV."""
    arrs, _ = _inputs(17, 192)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    out, lse = tattn.flash_attention_plain(q, k, v, True)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    do[:, 150:] = 0.0
    lse[:, :, :150] = -1e30
    _, dk, dv = tattn.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    assert torch.equal(dk[:, 150:], torch.zeros_like(dk[:, 150:]))
    assert torch.equal(dv[:, 150:], torch.zeros_like(dv[:, 150:]))


def test_backward_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 128, 2, 128))
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_bwd_dkv_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_bwd_dq_cuda(q, q, q, q, lse, lse)


def test_cpu_tensors_never_launch_the_backward_kernels():
    arrs, w = _inputs(19, 128)
    before = (tattn.flash_fwd_cuda.launches,
              tattn.flash_bwd_dkv_cuda.launches,
              tattn.flash_bwd_dq_cuda.launches)
    _torch_grads(arrs, w, True, torch.float32)
    assert (tattn.flash_fwd_cuda.launches,
            tattn.flash_bwd_dkv_cuda.launches,
            tattn.flash_bwd_dq_cuda.launches) == before


@pytest.mark.parametrize("D", [16, 64])
def test_padded_head_dim_grads_equal_unpadded(D):
    """The backward wrappers' padding: q, k, v, O and dO padded with zeros
    along D, the unpadded scale, dQ, dK, dV sliced back. On the plain
    version that equals the unpadded gradients (f32, 1e-6), a ragged
    causal length included, and the padded columns are 0."""
    (q, k, v), w = _inputs(D, 200, D=D)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, w))
    o, lse = tattn.flash_attention_plain(q, k, v)
    want = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do)
    padded = [tattn.pad_head(t) for t in (q, k, v, o)]
    got = tattn.flash_attention_bwd_plain(*padded, lse, tattn.pad_head(do),
                                          scale=tattn.default_scale(q))
    for g, r, name in zip(got, want, "qkv"):
        assert g.shape[-1] == tattn.KERNEL_HEAD_DIM
        np.testing.assert_allclose(g[..., :D].numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"d{name}")
        assert not g[..., D:].any()

