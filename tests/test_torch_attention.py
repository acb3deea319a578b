"""The port's flash attention (``ray_tpu_torch.ops.attention``) against the
JAX package's flash kernel body.

The JAX side runs its Pallas forward kernel in interpret mode on the CPU
(``FORCE_PALLAS_INTERPRET``, as ``tests/test_ops.py`` does) and the LSE is
read from ``_flash_fwd``'s residuals; the port's side takes its plain
version, which is what a CPU tensor gets. Inputs come from numpy.

Tolerances: f32 2e-4 (rtol and atol, as ``tests/test_ops.py``); bf16 5e-2,
the reference's own bf16 bound: both round P to bf16 before P.V, but the
TPU kernel rounds relative to its running max over 1024-key blocks and the
plain version relative to the row max, and the two frameworks sum in
different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402

F32_TOL, BF16_TOL = 2e-4, 5e-2


@pytest.fixture(autouse=True)
def _force_interpret():
    jattn.FORCE_PALLAS_INTERPRET = True
    yield
    jattn.FORCE_PALLAS_INTERPRET = False


def _qkv(seed, B, S, H, D):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _jax_fwd(arrs, causal, jdtype):
    q, k, v = (jnp.asarray(a, jdtype) for a in arrs)
    out, res = jattn._flash_fwd(q, k, v, causal)
    S = q.shape[1]
    lse = res[4]
    lse = None if lse is None else np.asarray(lse)[:, :, :S]
    return np.asarray(out.astype(jnp.float32)), lse


def _torch_fwd(arrs, causal, tdtype):
    q, k, v = (torch.from_numpy(a).to(tdtype) for a in arrs)
    out, lse = tattn.flash_attention(q, k, v, causal, return_lse=True)
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("S,causal", [(128, True), (256, True),
                                      (128, False), (256, False),
                                      (200, True)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_matches_jax_kernel(S, causal, dtype):
    """O and LSE against the Pallas kernel body (interpret mode),
    including a ragged causal length the kernel masks by index."""
    jd, td, tol = {"f32": (jnp.float32, torch.float32, F32_TOL),
                   "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    arrs = _qkv(S + int(causal), 1, S, 2, 64)
    jo, jlse = _jax_fwd(arrs, causal, jd)
    to, tlse = _torch_fwd(arrs, causal, td)
    assert jlse is not None, "the JAX side did not run its kernel"
    np.testing.assert_allclose(to, jo, rtol=tol, atol=tol)
    np.testing.assert_allclose(tlse, jlse, rtol=F32_TOL, atol=F32_TOL)


def test_short_sequence_takes_plain_attention():
    """Below 128 tokens both packages use plain attention (exact in f32);
    the port still returns the LSE on request."""
    arrs = _qkv(7, 2, 64, 2, 32)
    jo, jlse = _jax_fwd(arrs, True, jnp.float32)
    assert jlse is None
    to, tlse = _torch_fwd(arrs, True, torch.float32)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    q, k, _ = (torch.from_numpy(a) for a in arrs)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32)
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    np.testing.assert_allclose(tlse, torch.logsumexp(s, -1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_non_causal_needs_multiple_of_128():
    q = torch.zeros((1, 200, 2, 64))
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(q, q, q, causal=False)


def test_cpu_tensors_never_launch_the_kernel():
    arrs = _qkv(3, 1, 128, 2, 64)
    before = tattn.flash_fwd_cuda.launches
    _torch_fwd(arrs, True, torch.float32)
    assert tattn.flash_fwd_cuda.launches == before


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dim_equals_unpadded(D, causal):
    """What the kernel wrappers do with a head dim below 128: q, k, v
    padded with zeros along D (``pad_head``), scaled by the unpadded
    1/sqrt(D), O sliced back. On the plain version that equals the
    unpadded function (f32, 1e-6), and the padded columns of O are 0."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(D, 1, 256, 2, D))
    want_o, want_lse = tattn.flash_attention_plain(q, k, v, causal)
    got_o, got_lse = tattn.flash_attention_plain(
        *(tattn.pad_head(t) for t in (q, k, v)), causal,
        scale=tattn.default_scale(q))
    assert got_o.shape == (1, 256, 2, tattn.KERNEL_HEAD_DIM)
    np.testing.assert_allclose(got_o[..., :D].numpy(), want_o.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not got_o[..., D:].any()


def test_head_dim_above_128_raises():
    q = torch.zeros((1, 128, 2, 256))
    with pytest.raises(ValueError, match="head dim 256"):
        tattn.flash_fwd_cuda(q, q, q)

