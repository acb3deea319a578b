"""Training over meshes on the port (``build_train_step(mesh=...)``,
``context_parallel_attention``, ``run_pod_training``'s mesh axes) against
the JAX package's steps over the same meshes on the 8 CPU devices.

The same weights go to both packages (the JAX package's ``init_params``,
through numpy); batches come from numpy. The optimizer is
``optax.adamw(1e-3)`` and its torch form (``torch.optim.AdamW`` at lr
1e-3 and optax's weight decay, 1e-4).

Tolerances:
- the MoE Llama on ``{"data": 2, "expert": 4}`` and the dense one on
  ``{"fsdp": 4, "tensor": 2}``, f32: three losses within 1e-5 (rtol and
  atol), as ``tests/test_torch_train.py`` holds the one-device step;
- context-parallel steps (ring over ``seq`` = 4, Ulysses over ``seq`` =
  2) against the JAX package's one-device step: rtol 2e-3, the
  reference's own test's bound (``tests/test_ring_attention.py``);
- the sharded update on ``{"data": 4}`` against the JAX package's
  ``build_zero_train_step`` (its explicit route, on the interpreted
  ring): losses within 1e-5; against the port's ``build_zero_train_step``
  over the mesh's ring: bit for bit (the same code);
- ``run_pod_training`` on a virtual mesh against its one-device run: bit
  for bit (partitioning changes no value).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding as JNamed  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ray_tpu import parallel as J  # noqa: E402
from ray_tpu.models import llama as JL  # noqa: E402
from ray_tpu.parallel import zero as JZ  # noqa: E402
from ray_tpu_torch import parallel as T  # noqa: E402
from ray_tpu_torch.models import llama as TL  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 1e-5
CP_RTOL = 2e-3
STEPS = 3
CPU8 = ["cpu"] * 8
OPT = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)


@pytest.fixture(autouse=True)
def _two_threads():
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


def _configs(**kw):
    return (JL.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            TL.LlamaConfig.tiny(dtype=torch.float32, **kw))


def _tokens(seed, B, S):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(
        np.int32)


def _jax_losses(jc, jparams, tokens, mesh, attn_impl=None, batch_sh=None):
    sh = J.llama_param_shardings(jc, mesh)
    opt = optax.adamw(1e-3)
    state = J.create_train_state(J.shard_params(jparams, sh), opt)
    bsh = batch_sh or J.batch_sharding(mesh)
    step = J.build_train_step(
        lambda p, b: JL.loss_fn(p, b, jc, attn_impl=attn_impl), opt, mesh,
        sh, bsh)
    batch = {"tokens": jax.device_put(tokens, bsh)}
    out = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    return out


def _port_losses(tc, tparams, tokens, mesh, attn_impl=None, **kw):
    sh = T.llama_param_shardings(tc, mesh)
    state = T.create_train_state(T.shard_params(tparams, sh), OPT,
                                 device=mesh.device)
    step = T.build_train_step(
        lambda p, b: TL.loss_fn(p, b, tc, attn_impl=attn_impl), OPT,
        mesh=mesh, param_shardings=sh,
        batch_shardings=T.batch_sharding(mesh), **kw)
    out = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(tokens).long()})
        out.append(float(m["loss"]))
    return out, state


@pytest.mark.parametrize("axes,kw", [
    ({"data": 2, "expert": 4}, dict(n_experts=4, moe_top_k=2,
                                    hidden_dim=64)),
    ({"fsdp": 4, "tensor": 2}, {}),
    ({"data": 2, "fsdp": 2, "tensor": 2}, dict(n_experts=2, moe_top_k=1))])
def test_mesh_step_matches_reference(axes, kw):
    jc, tc = _configs(**kw)
    jp = JL.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(_np(jp), tc, "cpu")   # before JAX donates jp
    tokens = _tokens(0, 8, 33)
    want = _jax_losses(jc, jp, tokens, J.make_mesh(axes))
    got, state = _port_losses(tc, tp, tokens,
                              T.make_mesh(axes, devices=CPU8))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got[-1] < got[0]
    assert state.step == STEPS


@pytest.mark.parametrize("remat", [False, "dots"])
@pytest.mark.parametrize("impl,seq", [("ring", 4), ("ulysses", 2)])
def test_context_parallel_training_matches_single_device(impl, seq, remat):
    """The sequence dim sharded over a ``seq`` axis of virtual ranks (65
    tokens: the model sees 64, split evenly) reproduces the JAX
    package's one-device loss curve; under ``remat="dots"`` too (the
    ring's per-block checkpoints inside the layer's)."""
    jc, tc = _configs(max_seq_len=64, remat=remat)
    jp = JL.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(_np(jp), tc, "cpu")   # before JAX donates jp
    tokens = _tokens(0, 4, 65)
    one = J.make_mesh({"data": 1}, devices=jax.devices()[:1])
    want = _jax_losses(jc, jp, tokens, one, "xla", J.replicated(one))
    mesh = T.make_mesh({"seq": seq}, devices=["cpu"] * seq)
    got, _ = _port_losses(tc, tp, tokens, mesh,
                          T.context_parallel_attention(mesh, impl=impl))
    np.testing.assert_allclose(got, want, rtol=CP_RTOL)
    assert got[-1] < got[0]


def test_sharded_update_on_a_data_mesh_is_the_zero_ring():
    """``weight_update="sharded"`` on a mesh whose only axis above 1 is
    ``data``: the ZeRO rewrite over the mesh's RingGroup, equal to the
    JAX package's explicit ZeRO step, and bit for bit to the port's."""
    jc, tc = _configs()
    jp = JL.init_params(jc, jax.random.key(1))
    host = _np(jp)                               # before JAX donates jp
    tokens = _tokens(2, 8, 17)
    jmesh = J.make_mesh({"data": 4}, devices=jax.devices()[:4])
    opt = optax.adamw(1e-3)
    jstate = JZ.create_zero_state(jp, opt, jmesh, "data")
    jstep = JZ.build_zero_train_step(
        lambda p, b: JL.loss_fn(p, b, jc), opt, jmesh, "data",
        collective="pallas_interpret")
    jb = {"tokens": jax.device_put(tokens, JNamed(jmesh, JP("data")))}
    want = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, jb)
        want.append((float(m["loss"]), float(m["grad_norm"])))

    mesh = T.make_mesh({"data": 4}, devices=["cpu"] * 4)
    tparams = params_from_numpy(host, tc, "cpu")

    def loss(p, b):
        return TL.loss_fn(p, b, tc)

    step = T.build_train_step(loss, OPT, mesh=mesh, weight_update="sharded",
                              params_shape=tparams)
    ring = mesh.ring_group("data")
    zstate = T.create_zero_state(tparams, OPT, ring)
    zstep = T.build_zero_train_step(loss, OPT, ring)
    state = T.create_train_state(params_from_numpy(host, tc, "cpu"), OPT,
                                 device="cpu")
    batch = {"tokens": torch.from_numpy(tokens).long()}
    got = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        zstate, zm = zstep(zstate, batch)
        assert torch.equal(m["loss"], zm["loss"])
        assert torch.equal(m["grad_norm"], zm["grad_norm"])
        got.append((float(m["loss"]), float(m["grad_norm"])))
    assert isinstance(state, T.ZeroTrainState)
    assert torch.equal(state.flat, zstate.flat)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sharded_update_refusals_keep_the_reference_text():
    mesh = T.make_mesh({"data": 2}, devices=["cpu"] * 2)
    loss = lambda p, b: None  # noqa: E731
    with pytest.raises(ValueError, match="'sharded' needs params_shape"):
        T.build_train_step(loss, mesh=mesh, weight_update="sharded")
    with pytest.raises(ValueError, match="weight_update must be"):
        T.build_train_step(loss, mesh=mesh, weight_update="zero")
    step = T.build_train_step(loss, OPT, mesh=mesh, weight_update="sharded",
                              params_shape={"w": (4,)})
    state = T.create_train_state({"w": torch.zeros(4)}, OPT, device="cpu")
    state.step = 1
    with pytest.raises(ValueError, match="taken no step"):
        step(state, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="not the mesh's"):
        T.build_train_step(loss, mesh=mesh, device="meta")


def test_sharded_update_on_a_mixed_mesh_is_the_one_device_step():
    """With another axis above 1, GSPMD's sharded moments change no
    value: the step is the one-device step over the whole batch."""
    jc, tc = _configs()
    host = _np(JL.init_params(jc, jax.random.key(2)))
    tokens = _tokens(3, 8, 17)
    mixed = T.make_mesh({"data": 2, "tensor": 2}, devices=["cpu"] * 4)
    tp = params_from_numpy(host, tc, "cpu")
    got, state = _port_losses(tc, tp, tokens, mixed,
                              weight_update="sharded", params_shape=tp)
    want, _ = _port_losses(tc, params_from_numpy(host, tc, "cpu"), tokens,
                           T.make_mesh({"data": 1}, devices=["cpu"]))
    assert got == want
    assert isinstance(state, T.TrainState)


def test_eval_step_over_a_mesh():
    jc, tc = _configs()
    tp = params_from_numpy(_np(JL.init_params(jc, jax.random.key(0))), tc,
                           "cpu")
    mesh = T.make_mesh({"fsdp": 2}, devices=["cpu"] * 2)
    batch = {"tokens": _tokens(1, 2, 9)}
    ev = T.build_eval_step(lambda p, b: TL.loss_fn(p, b, tc), mesh=mesh,
                           batch_shardings=T.batch_sharding(mesh))
    want = T.build_eval_step(lambda p, b: TL.loss_fn(p, b, tc), "cpu")
    assert torch.equal(ev(tp, batch), want(tp, batch))


def test_run_pod_training_on_a_virtual_mesh():
    """Non-data axes at world size 1 make a mesh of virtual ranks; the
    losses are the one-device run's, bit for bit."""
    from ray_tpu_torch.train.cuda_backend import run_pod_training

    cfg = TL.LlamaConfig.tiny(dtype=torch.float32)
    losses = {}
    for name, axes in (("one", None), ("mesh", {"fsdp": 2, "tensor": 2}),
                       ("moe", {"expert": 2})):
        model = cfg if name != "moe" else TL.LlamaConfig.tiny(
            dtype=torch.float32, n_experts=2)
        rows = []
        summary = run_pod_training(model_config=model, mesh_axes=axes,
                                   steps=2, device="cpu",
                                   report=lambda m: rows.append(m["loss"]))
        losses[name] = rows
        if axes:
            assert summary["mesh"] == axes
        assert np.isfinite(summary["loss"])
    assert losses["mesh"] == losses["one"]


def test_gangs_refuse_other_axes_naming_the_slice():
    from ray_tpu_torch.train.cuda_backend import _data_ranks

    with pytest.raises(NotImplementedError,
                       match="mesh across processes"):
        _data_ranks({"data": 1, "fsdp": 2}, world_size=2)
    assert _data_ranks({"data": 2, "fsdp": 2}, world_size=1) == 4
    assert _data_ranks({"seq": 4}, world_size=1) == 1
