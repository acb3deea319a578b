"""The port's Llama (``ray_tpu_torch.models``) against ``ray_tpu.models.llama``.

The same weights go to both packages: the JAX package's ``init_params``
output, converted to numpy and loaded with ``params_from_numpy``. Token
inputs come from numpy.

Tolerances: f32 compute, 1e-4 absolute on logits and caches (summation
order only) and identical greedy tokens; bf16 compute, 5e-2 absolute (the
reference's own bf16 bound: the frameworks round at the same places but
sum matmuls in different orders) and identical tokens over a short
generation; int8 quantization bit-identical.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402

F32_TOL, BF16_TOL = 1e-4, 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
_CACHE = {}


def to_numpy(tree):
    """JAX param tree -> numpy (bf16 upcast to f32 first)."""
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree_util.tree_map(leaf, tree)


def _pair(dtype, **overrides):
    key = (dtype, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        jd, td, _ = DTYPES[dtype]
        jc = J.LlamaConfig.tiny(dtype=jd, **overrides)
        tc = T.LlamaConfig.tiny(dtype=td, **overrides)
        jp = J.init_params(jc, jax.random.key(0))
        tp = params_from_numpy(to_numpy(jp), tc, "cpu")
        _CACHE[key] = (jc, jp, tc, tp)
    return _CACHE[key]


def _tokens(seed, B, P, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, P)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_logits(dtype):
    jc, jp, tc, tp = _pair(dtype)
    toks = _tokens(0, 2, 24)
    want = np.asarray(J.forward(jp, jnp.asarray(toks), jc))
    got = T.forward(tp, _t(toks), tc)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, DTYPES[dtype][2])
    assert tc.num_params() == jc.num_params()
    assert (T.LlamaConfig.llama3_8b().num_params()
            == J.LlamaConfig.llama3_8b().num_params())
    # The nn.Module view computes the same thing.
    model = T.Llama(tc, tp)
    _close(model(_t(toks)).numpy(), got.numpy(), 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_kv(dtype):
    jc, jp, tc, tp = _pair(dtype)
    toks = _tokens(1, 1, 19)
    jx, jks, jvs = J.prefill_kv(jp, jnp.asarray(toks), jc)
    tx, tks, tvs = T.prefill_kv(tp, _t(toks), tc)
    tol = DTYPES[dtype][2]
    for got, want in ((tx, jx), (tks, jks), (tvs, jvs)):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
               tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_and_cache(dtype):
    """One decode step after a prefill, with one slot inactive: logits
    and the updated cache agree, and the inactive slot's cache rows are
    bit-for-bit untouched."""
    jc, jp, tc, tp = _pair(dtype)
    toks = _tokens(2, 2, 9)
    jl, jcache = J.prefill(jp, jnp.asarray(toks), jc, max_len=16)
    tl, tcache = T.prefill(tp, _t(toks), tc, max_len=16)
    tol = DTYPES[dtype][2]
    _close(tl.numpy(), np.asarray(jl), tol)
    nxt = np.asarray([5, 7], np.int32)
    pos = np.asarray([9, 9], np.int32)
    active = np.asarray([True, False])
    jl2, jcache2 = J.decode_step(jp, jcache, jnp.asarray(nxt),
                                 jnp.asarray(pos), jc,
                                 active=jnp.asarray(active))
    before = tcache["k"][:, 1].clone()
    tl2, tcache2 = T.decode_step(tp, tcache, _t(nxt), _t(pos), tc,
                                 active=torch.from_numpy(active))
    _close(tl2[0].numpy(), np.asarray(jl2)[0], tol)   # row 1 is garbage
    for name in ("k", "v"):
        _close(tcache2[name].float().numpy(),
               np.asarray(jcache2[name].astype(jnp.float32)), tol)
    assert torch.equal(tcache2["k"][:, 1], before)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_generate_tokens(dtype):
    jc, jp, tc, tp = _pair(dtype)
    toks = _tokens(3, 2, 12)
    want = np.asarray(J.generate(jp, jnp.asarray(toks), jc, 8))
    got = T.generate(tp, _t(toks), tc, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_int8_bit_identical_and_generate():
    jc, jp, tc, tp = _pair("bf16")
    jq = J.quantize_weights_int8(jp)
    tq = T.quantize_weights_int8(tp)
    jq_np = to_numpy(jq)
    assert set(tq) == set(jq_np) and set(tq["layers"]) == set(jq_np["layers"])
    for name, want in jq_np["layers"].items():
        got = tq["layers"][name]
        assert tuple(got.shape) == want.shape, name
        if name.endswith("_q"):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)
        elif name.endswith("_s"):
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq["lm_head_q"].numpy(), jq_np["lm_head_q"])
    np.testing.assert_array_equal(tq["lm_head_s"].numpy(), jq_np["lm_head_s"])
    # An int8 tree converted from JAX generates the same tokens.
    tq2 = params_from_numpy(jq_np, tc, "cpu")
    toks = _tokens(4, 1, 10)
    want = np.asarray(J.generate(jq, jnp.asarray(toks), jc, 8))
    np.testing.assert_array_equal(T.generate(tq2, _t(toks), tc, 8).numpy(),
                                  want)
    np.testing.assert_array_equal(T.generate(tq, _t(toks), tc, 8).numpy(),
                                  want)


def test_flash_prefill_at_bucket_128():
    """attn_impl="flash" with a 128-token prompt: the port's plain flash
    path against the reference's Pallas kernel in interpret mode."""
    jc, jp, tc, tp = _pair("f32", attn_impl="flash", max_seq_len=160)
    toks = _tokens(5, 1, 128)
    jattn.FORCE_PALLAS_INTERPRET = True
    try:
        jx, jks, _ = J.prefill_kv(jp, jnp.asarray(toks), jc)
    finally:
        jattn.FORCE_PALLAS_INTERPRET = False
    tx, tks, _ = T.prefill_kv(tp, _t(toks), tc)
    _close(tx.numpy(), np.asarray(jx), F32_TOL)
    _close(tks.numpy(), np.asarray(jks), F32_TOL)


def test_default_device_is_the_card():
    """Entry points with no device run on the card; without one they
    raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(T.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(to_numpy(_pair("f32")[1]), T.LlamaConfig.tiny())


def test_later_slices_raise():
    with pytest.raises(NotImplementedError):
        T.init_params(T.LlamaConfig.tiny(n_experts=4), device="cpu")
    _, _, tc, tp = _pair("f32")
    toks = _t(_tokens(6, 1, 4))
    with pytest.raises(NotImplementedError):
        T.forward(tp, toks, T.LlamaConfig.tiny(attn_impl="ring"))


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_keeps_loss_and_grads(remat):
    """Checkpointed layers (whole, or keeping the weight matmuls) give the
    loss and every gradient of the plain run: recomputation repeats the
    same arithmetic. At 128 positions the attention is the flash route's
    autograd Function, which the checkpoint reruns."""
    _, _, tc, tp = _pair("f32")
    batch = {"tokens": _t(_tokens(8, 2, 129))}

    def run(cfg):
        p = {k: ({n: t.clone().requires_grad_(True) for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in tp.items()}
        loss = T.loss_fn(p, batch, cfg)
        loss.backward()
        grads = [p["embed"].grad, p["lm_head"].grad, p["norm_f"].grad]
        grads += [p["layers"][k].grad for k in sorted(p["layers"])]
        return loss.detach(), grads

    base = dataclasses.replace(tc, attn_impl="flash")
    loss0, grads0 = run(base)
    loss1, grads1 = run(dataclasses.replace(base, remat=remat))
    _close(loss1.numpy(), loss0.numpy(), 1e-6)
    for g1, g0 in zip(grads1, grads0):
        _close(g1.numpy(), g0.numpy(), 1e-6)


def test_unknown_remat_raises():
    _, _, tc, tp = _pair("f32")
    with pytest.raises(ValueError, match="remat"):
        T.forward(tp, _t(_tokens(6, 1, 4)),
                  dataclasses.replace(tc, remat="full"))
