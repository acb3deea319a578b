"""The port's training half (``ray_tpu_torch.ops.fused_loss``, the training
functions of ``models.llama`` and ``parallel.train_step``) against the JAX
package.

The same weights go to both packages (the JAX package's ``init_params``,
converted through numpy); tokens, masks and hidden states come from
numpy. The reference's loss is called with ``fused`` given, so nothing
depends on ``RAY_TPU_FUSED_LOSS``.

Tolerances: f32 throughout, where only summation order differs: losses
and gradients 1e-5 (rtol and atol; 1e-4 where a gradient sums over the
whole batch), params after three AdamW steps 1e-5. The embedding's
gradient in bf16 is held to one bf16 ulp (2**-7 of the value), since both
sum in f32 and round once.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as J  # noqa: E402
from ray_tpu.ops.fused_loss import blockwise_xent as j_xent  # noqa: E402
from ray_tpu_torch.models import llama as T  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)
from ray_tpu_torch.ops.fused_loss import blockwise_xent  # noqa: E402
from ray_tpu_torch.parallel import (  # noqa: E402
    build_eval_step, build_train_step, create_train_state)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test runs, restored after it: these
    tests share the host with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """JAX tree -> numpy copies (bf16 upcast to f32)."""
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.array(a.astype(jnp.float32))
        return np.array(a)
    return jax.tree_util.tree_map(leaf, tree)


def _models(dtype=torch.float32, jdtype=jnp.float32, **overrides):
    jc = J.LlamaConfig.tiny(dtype=jdtype, **overrides)
    tc = T.LlamaConfig.tiny(dtype=dtype, **overrides)
    jp = J.init_params(jc, jax.random.key(0))
    return jc, jp, tc, params_from_numpy(_np(jp), tc, "cpu")


def _tokens(seed, B, S, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _grad_leaves(tree):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update({f"{name}.{k}": v for k, v in value.items()})
        else:
            out[name] = value
    return out


def _port_grads(tp, loss):
    loss.backward()
    return {k: v.grad.float().numpy()
            for k, v in _grad_leaves(tp).items()}


def _leaf_params(tp):
    return {name: ({k: t.clone().requires_grad_(True)
                    for k, t in value.items()}
                   if isinstance(value, dict)
                   else value.clone().requires_grad_(True))
            for name, value in tp.items()}


# ---------------------------------------------------------------------------
# blockwise_xent
# ---------------------------------------------------------------------------

def test_blockwise_xent_matches_reference():
    """Forward and grads against the reference op, with a vocabulary (500)
    that the block (96) does not divide."""
    rng = np.random.RandomState(7)
    h = rng.standard_normal((48, 16)).astype(np.float32)
    head = rng.standard_normal((16, 500)).astype(np.float32)
    t = rng.randint(0, 500, 48).astype(np.int32)
    g = rng.standard_normal(48).astype(np.float32)

    def jloss(h, hd):
        return jnp.sum(j_xent(h, hd, jnp.asarray(t), 96) * g)

    jn = np.asarray(j_xent(jnp.asarray(h), jnp.asarray(head),
                           jnp.asarray(t), 96))
    jgh, jghd = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    thd = torch.from_numpy(head).requires_grad_(True)
    nll = blockwise_xent(th, thd, torch.from_numpy(t), 96)
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), jn, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(thd.grad.numpy(), np.asarray(jghd),
                               rtol=TOL, atol=TOL)
    # And against plain cross-entropy over the materialized logits.
    ref = torch.nn.functional.cross_entropy(
        torch.from_numpy(h) @ torch.from_numpy(head),
        torch.from_numpy(t).long(), reduction="none")
    np.testing.assert_allclose(nll.detach().numpy(), ref.numpy(),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_matches_reference_fused_and_unfused(masked):
    """Loss and every gradient leaf: the port's fused and unfused routes
    against each other and against the reference's fused route."""
    jc, jp, tc, tp = _models()
    toks = _tokens(1, 2, 17)
    batch = {"tokens": toks}
    if masked:
        batch["mask"] = (np.random.RandomState(2).rand(2, 17) > 0.3
                         ).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: J.loss_fn(p, jbatch, jc, fused=True)))(jp)
    jg = _grad_leaves(_np(jg))
    for fused in (True, False):
        p = _leaf_params(tp)
        loss = T.loss_fn(p, tbatch, tc, fused=fused)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL,
                                   atol=TOL)
        for name, g in _port_grads(p, loss).items():
            np.testing.assert_allclose(g, jg[name], rtol=1e-4, atol=TOL,
                                       err_msg=f"fused={fused} d{name}")


def test_flops_per_token_matches_reference():
    for name in ("tiny", "llama3_8b"):
        jc, tc = getattr(J.LlamaConfig, name)(), getattr(T.LlamaConfig,
                                                         name)()
        assert T.flops_per_token(tc, 1024) == J.flops_per_token(jc, 1024)


# ---------------------------------------------------------------------------
# Embedding gradient
# ---------------------------------------------------------------------------

def test_embedding_grad_sums_repeated_tokens_in_f32():
    """bf16 table, tokens repeated hundreds of times: both sides sum the
    rows' gradients in f32 and round once, so they agree to one bf16 ulp,
    where a bf16 running sum would drift far further."""
    rng = np.random.RandomState(3)
    table = rng.standard_normal((32, 8)).astype(np.float32) * 0.02
    toks = np.concatenate([np.full(600, 5), rng.randint(0, 32, 200)]
                          ).astype(np.int32).reshape(4, 200)
    g = rng.standard_normal((4, 200, 8)).astype(np.float32)

    jtab = jnp.asarray(table, jnp.bfloat16)
    jgrad = jax.grad(lambda e: jnp.sum(
        J.embed_lookup(e, jnp.asarray(toks)).astype(jnp.float32)
        * g))(jtab)
    ttab = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    out = T._embed({"embed": ttab}, torch.from_numpy(toks).long(),
                   torch.bfloat16)
    (out.float() * torch.from_numpy(g)).sum().backward()
    ref = np.asarray(jgrad.astype(jnp.float32))
    got = ttab.grad.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=0)
    exact = np.zeros_like(table)
    np.add.at(exact, toks.reshape(-1), g.reshape(-1, 8))
    np.testing.assert_allclose(got[5], exact[5], rtol=2.0 ** -7)


# ---------------------------------------------------------------------------
# build_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_reference(grad_accum):
    """Three steps at ``tiny`` against the reference's build_train_step
    with optax.adamw(1e-4) on a one-device mesh: loss, grad norm and every
    param after each step."""
    from ray_tpu.parallel import (
        batch_sharding, llama_param_shardings, make_mesh, shard_params)
    from ray_tpu.parallel import build_train_step as j_build
    from ray_tpu.parallel import create_train_state as j_create

    jc, jp, tc, tp = _models()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    sh = llama_param_shardings(jc, mesh)
    bs = batch_sharding(mesh)
    opt = optax.adamw(1e-4)
    jstate = j_create(shard_params(jp, sh), opt)
    jstep = j_build(lambda p, b: J.loss_fn(p, b, jc, fused=True), opt,
                    mesh, sh, bs, grad_accum=grad_accum)
    state = create_train_state(tp, device="cpu")
    step = build_train_step(lambda p, b: T.loss_fn(p, b, tc),
                            grad_accum=grad_accum, device="cpu")
    for i in range(3):
        toks = _tokens(10 + i, 4, 17)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks.astype(np.int64)})
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TOL,
                                   atol=TOL)
        ref = _grad_leaves(_np(jstate.params))
        for name, got in _grad_leaves(params_to_numpy(state.params)).items():
            np.testing.assert_allclose(got, ref[name], rtol=TOL, atol=TOL,
                                       err_msg=f"step {i + 1} {name}")


def test_train_steps_take_the_optimizer():
    """Three f32 steps at ``tiny`` under the reference's
    optax.sgd(1e-2, momentum=0.9) against torch.optim.SGD(lr=1e-2,
    momentum=0.9) given to create_train_state and build_train_step: loss,
    grad norm and every param after each step within 1e-5. A step given
    another factory than its state's raises."""
    from ray_tpu.parallel import (
        batch_sharding, llama_param_shardings, make_mesh, shard_params)
    from ray_tpu.parallel import build_train_step as j_build
    from ray_tpu.parallel import create_train_state as j_create

    jc, jp, tc, tp = _models()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    sh = llama_param_shardings(jc, mesh)
    opt = optax.sgd(1e-2, momentum=0.9)
    jstate = j_create(shard_params(jp, sh), opt)
    jstep = j_build(lambda p, b: J.loss_fn(p, b, jc, fused=True), opt,
                    mesh, sh, batch_sharding(mesh))
    make = functools.partial(torch.optim.SGD, lr=1e-2, momentum=0.9)
    state = create_train_state(tp, make, device="cpu")
    assert isinstance(state.optimizer, torch.optim.SGD)
    step = build_train_step(lambda p, b: T.loss_fn(p, b, tc), make,
                            device="cpu")
    for i in range(3):
        toks = _tokens(20 + i, 4, 17)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": toks.astype(np.int64)})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TOL,
                                   atol=TOL)
        ref = _grad_leaves(_np(jstate.params))
        for name, got in _grad_leaves(params_to_numpy(state.params)).items():
            np.testing.assert_allclose(got, ref[name], rtol=TOL, atol=TOL,
                                       err_msg=f"step {i + 1} {name}")
    other = build_train_step(lambda p, b: T.loss_fn(p, b, tc),
                             functools.partial(torch.optim.SGD, lr=1e-2),
                             device="cpu")
    with pytest.raises(ValueError, match="optimizer factory"):
        other(state, {"tokens": _tokens(23, 4, 17).astype(np.int64)})


def test_eval_step_matches_reference():
    """The loss of build_eval_step against the reference's build_eval_step
    on the same params and batch (f32, 1e-5), with no gradient kept."""
    from ray_tpu.parallel import (
        batch_sharding, llama_param_shardings, make_mesh, shard_params)
    from ray_tpu.parallel import build_eval_step as j_eval

    jc, jp, tc, tp = _models()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jparams = shard_params(jp, llama_param_shardings(jc, mesh))
    jfn = j_eval(lambda p, b: J.loss_fn(p, b, jc, fused=True), mesh,
                 batch_sharding(mesh))
    state = create_train_state(tp, device="cpu")
    fn = build_eval_step(lambda p, b: T.loss_fn(p, b, tc), device="cpu")
    for seed in (30, 31):
        toks = _tokens(seed, 4, 17)
        want = float(jfn(jparams, {"tokens": jnp.asarray(toks)}))
        got = fn(state.params, {"tokens": toks.astype(np.int64)})
        assert not got.requires_grad
        np.testing.assert_allclose(got.item(), want, rtol=TOL, atol=TOL)


def test_train_state_updates_in_place():
    _, _, tc, tp = _models()
    state = create_train_state(tp, device="cpu")
    wq = state.params["layers"]["wq"]
    before = wq.detach().clone()
    step = build_train_step(lambda p, b: T.loss_fn(p, b, tc), device="cpu")
    state2, _ = step(state, {"tokens": _tokens(4, 2, 9)})
    assert state2 is state and state.params["layers"]["wq"] is wq
    assert not torch.equal(wq.detach(), before)


def test_params_round_trip_through_numpy():
    for dtype in (torch.float32, torch.bfloat16):
        tc = T.LlamaConfig.tiny(param_dtype=dtype)
        tp = T.init_params(tc, 0, "cpu")
        back = params_from_numpy(params_to_numpy(tp), tc, "cpu")
        for name, t in _grad_leaves(tp).items():
            assert torch.equal(_grad_leaves(back)[name], t), name


def test_unported_options_raise():
    """Meshes and the sharded update are ported
    (``tests/test_torch_mesh_train.py``): what is left refuses with the
    reference's texts, and a collective group's mesh (one rank per
    process) names the slice that brings it."""
    from ray_tpu_torch.parallel import make_mesh

    loss = lambda p, b: None  # noqa: E731
    with pytest.raises(ValueError, match="'sharded' needs params_shape"):
        build_train_step(loss, weight_update="sharded", device="cpu")
    with pytest.raises(ValueError, match="give mesh="):
        build_train_step(loss, weight_update="sharded", params_shape={},
                         device="cpu")
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    mesh.group = object()
    with pytest.raises(NotImplementedError, match="mesh across processes"):
        build_train_step(loss, mesh=mesh)
    with pytest.raises(ValueError):
        build_train_step(loss, weight_update="zero", device="cpu")
    _, _, tc, tp = _models()
    step = build_train_step(lambda p, b: T.loss_fn(p, b, tc), grad_accum=3,
                            device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        step(create_train_state(tp, device="cpu"),
             {"tokens": _tokens(5, 4, 9)})
