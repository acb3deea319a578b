"""The port's MoE layer (``ray_tpu_torch.models.moe``) and the MoE Llama
against the JAX package's (``ray_tpu.models.moe``, ``ray_tpu.models.llama``).

Weights and inputs come from numpy seeds and go to both packages.

Tolerances:
- ``dispatch``, ``combine`` and the raw assignment: equal exactly, from
  the same router probabilities, ties included (the port's stable top-k
  keeps ``lax.top_k``'s lower-index-first order);
- the layer's output and aux loss at f32: 1e-5 (rtol and atol), the
  products summed in another order;
- the MoE Llama's logits and loss at f32: 1e-4 absolute, as
  ``tests/test_torch_llama.py`` holds the dense model;
- one expert with ample capacity against the dense SwiGLU FFN: 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as JL  # noqa: E402
from ray_tpu.models import moe as JM  # noqa: E402
from ray_tpu_torch.models import llama as TL  # noqa: E402
from ray_tpu_torch.models import moe as TM  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree_util.tree_map(leaf, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _configs(**kw):
    jc = JM.MoEConfig(dtype=jnp.float32, **kw)
    tc = TM.MoEConfig(dtype=torch.float32, **kw)
    return jc, tc


def _dispatch_pair(probs, k, capacity):
    jd, jcomb, jraw = JM._top_k_dispatch(jnp.asarray(probs), k, capacity,
                                         jnp.float32)
    td, tcomb, traw = TM._top_k_dispatch(torch.from_numpy(probs), k,
                                         capacity, torch.float32)
    return (np.asarray(jd), np.asarray(jcomb), np.asarray(jraw)), \
        (td.numpy(), tcomb.numpy(), traw.numpy())


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("k,E,cap", [(1, 4, 8), (2, 4, 16), (2, 8, 6),
                                     (4, 8, 64)])
def test_dispatch_equal_exactly(k, E, cap):
    probs = _softmax(np.random.RandomState(E + k).randn(48, E))
    want, got = _dispatch_pair(probs, k, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_tied_probabilities_dispatch_the_lower_expert_first():
    """Equal logits (as a bf16 product rounds them, common at 8 experts
    over thousands of tokens): the first k of a stable descending sort,
    as lax.top_k orders them."""
    rng = np.random.RandomState(3)
    logits = rng.randint(0, 3, (64, 8)).astype(np.float32)  # many ties
    logits[:8] = 0.0                                        # all tied
    probs = _softmax(logits)
    want, got = _dispatch_pair(probs, 2, 40)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    vals, idx = TM.top_k_stable(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx[:8].tolist() == [[0, 1]] * 8


def test_overflow_past_capacity_drops_tokens_as_the_reference():
    """Every token prefers expert 0: only the first C take its slots,
    the rest keep their second choice or nothing."""
    probs = np.full((32, 4), 0.1, np.float32)
    probs[:, 0] = 0.6
    probs[:, 1:] += np.random.RandomState(0).rand(32, 3).astype(
        np.float32) * 0.01
    want, got = _dispatch_pair(probs, 2, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    dispatch = got[0]
    assert dispatch[:, 0].sum() == 5                       # expert 0 full
    assert dispatch.sum() < 2 * 32                         # tokens dropped
    assert dispatch.sum(axis=(1, 2)).max() <= 2


def test_capacity_is_the_reference_s():
    for T, E, k, cf in [(16, 4, 2, 1.25), (4096, 8, 2, 1.25), (7, 8, 2, 1.0),
                        (100, 3, 1, 2.0)]:
        j = JM.MoEConfig(dim=8, hidden_dim=8, n_experts=E, top_k=k,
                         capacity_factor=cf)
        t = TM.MoEConfig(dim=8, hidden_dim=8, n_experts=E, top_k=k,
                         capacity_factor=cf)
        assert t.capacity(T) == j.capacity(T)


@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (8, 2, 0.5), (4, 1, 2.0)])
def test_moe_layer_matches_reference(E, k, cf):
    jc, tc = _configs(dim=32, hidden_dim=64, n_experts=E, top_k=k,
                      capacity_factor=cf)
    params = _np(JM.init_moe_params(jc, jax.random.key(0)))
    x = np.random.RandomState(1).randn(2, 16, 32).astype(np.float32)
    jo, jaux = JM.moe_layer(jnp.asarray(x), params, jc)
    to, taux = TM.moe_layer(torch.from_numpy(x), _t(params), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)
    assert float(taux) > 0


def test_moe_layer_grads_match_reference():
    jc, tc = _configs(dim=16, hidden_dim=32, n_experts=4, top_k=2)
    params = _np(JM.init_moe_params(jc, jax.random.key(0)))
    rng = np.random.RandomState(1)
    x = rng.randn(4, 8, 16).astype(np.float32)
    y = rng.randn(4, 8, 16).astype(np.float32)

    def jloss(p):
        out, aux = JM.moe_layer(jnp.asarray(x), p, jc)
        return jnp.mean((out - y) ** 2) + aux

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    out, aux = TM.moe_layer(torch.from_numpy(x), tp, tc)
    (((out - torch.from_numpy(y)) ** 2).mean() + aux).backward()
    for name in tp:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jg[name]), rtol=1e-4,
                                   atol=TOL)
    assert float(tp["router"].grad.abs().max()) > 0


def test_single_expert_equals_dense_ffn():
    """n_experts=1, top_k=1, ample capacity: the dense SwiGLU FFN."""
    _, tc = _configs(dim=16, hidden_dim=32, n_experts=1, top_k=1,
                     capacity_factor=2.0)
    p = TM.init_moe_params(tc, 0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 16).astype(
        np.float32))
    out, _ = TM.moe_layer(x, p, tc)
    xt = x.reshape(-1, 16)
    dense = (torch.nn.functional.silu(xt @ p["w_gate"][0])
             * (xt @ p["w_up"][0])) @ p["w_down"][0]
    np.testing.assert_allclose(out.reshape(-1, 16).numpy(), dense.numpy(),
                               rtol=TOL, atol=TOL)


def test_moe_param_shapes_and_specs():
    _, tc = _configs(dim=8, hidden_dim=12, n_experts=4, top_k=2)
    p = TM.init_moe_params(tc, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (8, 4), "w_gate": (4, 8, 12), "w_up": (4, 8, 12),
        "w_down": (4, 12, 8)}
    want = {k: tuple(v) for k, v in JM.moe_param_specs().items()}
    assert {k: tuple(v) for k, v in TM.moe_param_specs().items()} == want


def test_init_moe_params_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, tc = _configs(dim=8, hidden_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_moe_params(tc)


# ---------------------------------------------------------------- Llama

def _llama(**kw):
    jc = JL.LlamaConfig.tiny(dtype=jnp.float32, n_experts=4, moe_top_k=2,
                             hidden_dim=64, **kw)
    tc = TL.LlamaConfig.tiny(dtype=torch.float32, n_experts=4, moe_top_k=2,
                             hidden_dim=64, **kw)
    jp = JL.init_params(jc, jax.random.key(0))
    return jc, jp, tc, params_from_numpy(_np(jp), tc, "cpu")


def test_moe_llama_forward_and_aux_match_reference():
    jc, jp, tc, tp = _llama()
    toks = np.random.RandomState(2).randint(0, 256, (2, 24)).astype(np.int32)
    jl, jaux = JL.forward(jp, jnp.asarray(toks), jc, return_aux=True)
    tl, taux = TL.forward(tp, torch.from_numpy(toks).long(), tc,
                          return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)
    assert float(taux) > 0
    assert torch.equal(TL.forward(tp, torch.from_numpy(toks).long(), tc),
                       tl)


@pytest.mark.parametrize("fused", [True, False])
def test_moe_llama_loss_and_grads_match_reference(fused):
    jc, jp, tc, tp = _llama()
    toks = np.random.RandomState(4).randint(0, 256, (2, 17)).astype(np.int32)
    jloss, jg = jax.value_and_grad(
        lambda p: JL.loss_fn(p, {"tokens": jnp.asarray(toks)}, jc,
                             fused=fused))(jp)
    leaves = {**{k: v for k, v in tp.items() if k != "layers"},
              **tp["layers"]}
    for t in leaves.values():
        t.requires_grad_(True)
    loss = TL.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()}, tc,
                      fused=fused)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    for name in ("router", "w_gate", "w_down", "wq"):
        np.testing.assert_allclose(tp["layers"][name].grad.numpy(),
                                   np.asarray(jg["layers"][name]),
                                   rtol=1e-4, atol=1e-5)


def test_moe_num_params_is_the_reference_s():
    for kw in ({}, {"n_experts": 4}, {"n_experts": 8, "tie_embeddings": True}):
        assert TL.LlamaConfig.tiny(**kw).num_params() == \
            JL.LlamaConfig.tiny(**kw).num_params()
    cfg = TL.LlamaConfig.tiny(n_experts=4)
    p = TL.init_params(cfg, 0, "cpu")
    total = sum(t.numel() for t in p["layers"].values()) + sum(
        t.numel() for k, t in p.items() if k != "layers")
    assert total == cfg.num_params()


def test_moe_params_convert_both_ways():
    jc, jp, tc, tp = _llama()
    assert tuple(tp["layers"]["w_gate"].shape) == (2, 4, 64, 64)
    assert tuple(tp["layers"]["router"].shape) == (2, 64, 4)
    back = params_to_numpy(tp)
    want = _np(jp)
    for name, value in want["layers"].items():
        np.testing.assert_array_equal(back["layers"][name], value)
    cfg = TL.LlamaConfig.tiny(n_experts=4, param_dtype=torch.bfloat16)
    own = TL.init_params(cfg, 0, "cpu")
    again = params_from_numpy(params_to_numpy(own), cfg, "cpu")
    for name, t in own["layers"].items():
        assert torch.equal(again["layers"][name], t), name


def test_moe_decode_raises():
    """The KV-cache paths refuse MoE configs with the reference's rule."""
    tc = TL.LlamaConfig.tiny(n_experts=2)
    tp = TL.init_params(tc, 0, "cpu")
    cache = TL.init_kv_cache(tc, 1, max_len=8, device="cpu")
    z = torch.zeros((1,), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="use forward"):
        TL.decode_step(tp, cache, z, z, tc)
    with pytest.raises(NotImplementedError, match="MoE"):
        TL.prefill_kv(tp, z[None], tc)
