"""The port's ZeRO data-parallel step (``ray_tpu_torch.parallel.zero``) on
the CPU, where the ring runs its plain versions, against the JAX package's
``build_zero_train_step(..., collective="pallas_interpret")`` and against
the port's own replicated and one-device steps.

Weights and batches come from numpy seeds and go to both packages.

Tolerances:
- against the JAX package (the reference test's model, n = 2 and 4, and
  the overlap test's at n = 8): params, loss and grad norm within 1e-5
  (rtol and atol) after three Adam steps. Both exchanges are bit-exact
  (tests/test_torch_ring.py), but Adam's per-element arithmetic is written
  twice, once in optax and once in torch.optim, and rounds differently;
- against the port's replicated step through ``RingGroup.allreduce`` at
  n = 2: bit for bit, since each element of a two-rank sum is one add
  either way and both run the same torch.optim arithmetic per element;
- a tiny Llama at n = 4 against the port's one-device ``build_train_step``
  on the whole batch (its loss scaled by n, to match ZeRO's summed
  gradients): params within 1e-5 after three AdamW steps, since the
  gradients are summed in another order;
- overlap against monolithic: 1e-5 (the chunked rings re-associate the
  adds);
- the int8 exchange (``quantized_grads``, ``error_feedback``) against the
  reference's on its Pallas int8 ring, SGD, three steps: params and
  ``ef`` within 1e-5 on at least 99.9% of elements, and everywhere within
  ``lr * (n - 1) * max scale * steps`` (``ef``: one max scale), since an
  int8 code may differ by one where an f32 gradient ulp sits on a rounding
  edge; and the reference's 60-step error-feedback convergence test, the
  port's three final mses within 1e-3 of the reference's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ray_tpu.parallel import zero as JZ  # noqa: E402
from ray_tpu.models import llama as JL  # noqa: E402
from ray_tpu_torch.models import llama as TL  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.parallel import (  # noqa: E402
    build_replicated_train_step, build_train_step, build_zero_train_step,
    create_train_state, create_zero_state,
)
from ray_tpu_torch.util.collective import RingGroup  # noqa: E402
from ray_tpu_torch.util.collective import quantized as Q  # noqa: E402
from ray_tpu_torch.util.collective import ring as R  # noqa: E402

TOL = 1e-5
IMPL = "pallas_interpret"
STEPS = 3


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test runs, restored after it: these
    tests share the host with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _linear(seed, d_in, d_out, rows, scale=1.0):
    rng = np.random.RandomState(seed)
    params = {"w": (rng.randn(d_in, d_out) * scale).astype(np.float32),
              "b": np.zeros((d_out,), np.float32)}
    batch = {"x": rng.randn(rows, d_in).astype(np.float32),
             "y": rng.randn(rows, d_out).astype(np.float32)}
    return params, batch


def _jloss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _tloss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def _jax_zero(params, batch, n, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    opt = optax.adam(1e-2)
    state = JZ.create_zero_state(
        jax.tree.map(jnp.asarray, params), opt, mesh, "data")
    step = JZ.build_zero_train_step(_jloss, opt, mesh, "data",
                                    collective=IMPL, **kw)
    bsh = NamedSharding(mesh, P("data"))
    jb = {k: jax.device_put(v, bsh) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {k: np.asarray(v) for k, v in state.params.items()}, metrics


def _port_zero(params, batch, n, make_step=build_zero_train_step,
               opt=None, **kw):
    group = RingGroup(n, device="cpu")
    opt = opt or functools.partial(torch.optim.Adam, lr=1e-2)
    state = create_zero_state({k: torch.from_numpy(v) for k, v in
                               params.items()}, opt, group)
    step = make_step(_tloss, opt, group, **kw)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state, metrics


def _assert_ranks_agree(state):
    for r in range(state.group.n):
        assert torch.equal(state.flat[r], state.flat[0]), r


@pytest.mark.parametrize("n", [2, 4])
def test_zero_matches_reference(n):
    """tests/test_pallas_collective.py:137-190's model, against the
    reference's ZeRO step on the Pallas ring in interpret mode."""
    params, batch = _linear(0, 13, 7, 4)
    want, jm = _jax_zero(params, batch, n)
    state, tm = _port_zero(params, batch, n)
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(), want[k],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm, jm, rtol=TOL, atol=TOL)
    _assert_ranks_agree(state)
    assert state.step == STEPS


def test_overlap_matches_reference_and_monolithic():
    """tests/test_overlap.py:143-182: the chunked split-phase step at
    n = 8, three chunks, against the reference's and the port's
    monolithic step."""
    n = 8
    params, batch = _linear(1, 64, 40, n * 4, scale=0.1)
    want, jm = _jax_zero(params, batch, n, overlap=True, n_chunks=3)
    over, om = _port_zero(params, batch, n, overlap=True, n_chunks=3)
    mono, mm = _port_zero(params, batch, n)
    assert over.layout[0] == "overlap" and len(over.layout) == 4
    for k in params:
        np.testing.assert_allclose(over.params[k].numpy(), want[k],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(over.params[k].numpy(),
                                   mono.params[k].numpy(), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(om, jm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(om, mm, rtol=TOL, atol=TOL)
    _assert_ranks_agree(over)


def test_zero_bitwise_equals_replicated_allreduce_step():
    """ZeRO at n = 2 against plain data parallelism whose summed gradient
    reaches every rank through RingGroup.allreduce: the same bits."""
    params, batch = _linear(2, 13, 7, 4)
    zero, zm = _port_zero(params, batch, 2)
    rep, rm = _port_zero(params, batch, 2,
                         make_step=build_replicated_train_step)
    assert rep.layout == ("replicated",)
    for k in params:
        assert torch.equal(zero.params[k], rep.params[k]), k
    assert zm == rm
    _assert_ranks_agree(rep)


def test_tiny_llama_zero_matches_one_device_step():
    n = 4
    cfg = TL.LlamaConfig.tiny(dtype=torch.float32)
    jp = JL.init_params(JL.LlamaConfig.tiny(dtype=jnp.float32),
                        jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tokens = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (n, 17)).astype(np.int64)
    opt = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)

    group = RingGroup(n, device="cpu")
    zstate = create_zero_state(params_from_numpy(np_params, cfg, "cpu"),
                               opt, group)
    zstep = build_zero_train_step(lambda p, b: TL.loss_fn(p, b, cfg), opt,
                                  group)
    one = create_train_state(params_from_numpy(np_params, cfg, "cpu"),
                             device="cpu")
    ostep = build_train_step(lambda p, b: n * TL.loss_fn(p, b, cfg),
                             device="cpu")
    for _ in range(STEPS):
        zstate, zm = zstep(zstate, {"tokens": tokens})
        one, om = ostep(one, {"tokens": tokens})
        np.testing.assert_allclose(n * zm["loss"].item(), om["loss"].item(),
                                   rtol=TOL, atol=TOL)
    got = zstate.params
    for name, value in one.params.items():
        if isinstance(value, dict):
            for k, v in value.items():
                np.testing.assert_allclose(got[name][k].numpy(),
                                           v.detach().numpy(), rtol=TOL,
                                           atol=TOL, err_msg=f"{name}.{k}")
        else:
            np.testing.assert_allclose(got[name].numpy(),
                                       value.detach().numpy(), rtol=TOL,
                                       atol=TOL, err_msg=name)
    _assert_ranks_agree(zstate)


@pytest.mark.parametrize("kw", [{"quantized_grads": True},
                                {"error_feedback": True},
                                {"quantized_grads": True,
                                 "error_feedback": True}])
def test_quantized_exchange_not_ported(kw):
    """The int8 exchange's options do what the reference's do:
    ``quantized_grads`` alone runs a step; ``error_feedback`` without it
    raises ValueError naming ``quantized_grads``; both on a state without
    an ``ef`` buffer raise ValueError at the step."""
    params, batch = _linear(5, 13, 7, 4)
    group = RingGroup(2, device="cpu")
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    state = create_zero_state({k: torch.from_numpy(v) for k, v in
                               params.items()}, opt, group)
    if not kw.get("quantized_grads"):
        with pytest.raises(ValueError, match="quantized_grads"):
            build_zero_train_step(_tloss, opt, group, **kw)
        return
    step = build_zero_train_step(_tloss, opt, group, **kw)
    if kw.get("error_feedback"):
        with pytest.raises(ValueError, match="ef buffer"):
            step(state, batch)
        return
    state, m = step(state, batch)
    assert np.isfinite(m["loss"].item()) and state.step == 1
    _assert_ranks_agree(state)


def _jax_qzero(params, batch, n, lr, ef=False, steps=STEPS, **kw):
    """The reference's quantized ZeRO step (SGD) over ``steps`` steps:
    (params, ef or None)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    opt = optax.sgd(lr)
    state = JZ.create_zero_state(jax.tree.map(jnp.asarray, params), opt,
                                 mesh, "data", error_feedback=ef)
    step = JZ.build_zero_train_step(
        kw.pop("loss", _jloss), opt, mesh, "data", collective=IMPL,
        quantized_grads=True, error_feedback=ef, **kw)
    bsh = NamedSharding(mesh, P("data"))
    jb = {k: jax.device_put(v, bsh) for k, v in batch.items()}
    for _ in range(steps):
        state, _ = step(state, jb)
    return ({k: np.asarray(v) for k, v in state.params.items()},
            None if state.ef is None else np.asarray(state.ef))


def _port_qzero(params, batch, n, lr, ef=False, steps=STEPS, **kw):
    group = RingGroup(n, device="cpu")
    opt = functools.partial(torch.optim.SGD, lr=lr)
    state = create_zero_state({k: torch.from_numpy(v) for k, v in
                               params.items()}, opt, group,
                              error_feedback=ef)
    step = build_zero_train_step(kw.pop("loss", _tloss), opt, group,
                                 quantized_grads=True, error_feedback=ef,
                                 **kw)
    for _ in range(steps):
        state, _ = step(state, batch)
    _assert_ranks_agree(state)
    return state


def _held_q(got, want, bound):
    """Within 1e-5 on at least 99.9% of elements, everywhere within
    ``bound`` (an int8 code may differ by one where an f32 gradient ulp
    sits on a rounding edge)."""
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= TOL).mean() >= 0.999, (err > TOL).sum()
    assert err.max() <= bound, (err.max(), bound)


@pytest.mark.parametrize("case", ["mono", "mono_ef", "overlap", "overlap_ef",
                                  "bf16_rung"])
def test_quantized_zero_matches_reference(case):
    """build_zero_train_step(quantized_grads=True) against the reference's
    on the Pallas int8 ring in interpret mode, SGD, three steps: the
    overlap test's model (monolithic at n = 4; overlap at n = 8 with 3
    chunks, each 1024 elements per rank, so the int8 rung), with and
    without error feedback, and the reference test's small model (bf16
    rung: 256 elements per rank)."""
    lr = 1e-2
    kw = {}
    if case == "bf16_rung":
        n = 2
        params, batch = _linear(6, 13, 7, 4)
    else:
        n = 8 if case.startswith("overlap") else 4
        params, batch = _linear(1, 64, 40, n * 4, scale=0.1)
        if case.startswith("overlap"):
            kw = {"overlap": True, "n_chunks": 3}
    ef = case.endswith("_ef")
    want, want_ef = _jax_qzero(params, batch, n, lr, ef=ef, **kw)
    state = _port_qzero(params, batch, n, lr, ef=ef, **kw)
    # Any scale on the wire is at most max|summed gradient| / 127; the
    # summed gradient is bounded from the port's last step and the batch.
    g = state.grads.abs().sum(0).max().item()
    max_scale = 4 * g / 127.0
    for k in params:
        _held_q(state.params[k].numpy(), want[k],
                lr * (n - 1) * max_scale * STEPS)
    if ef:
        assert state.ef.dtype == torch.float32
        assert state.ef.abs().max().item() > 0
        _held_q(state.ef.numpy(), want_ef, max_scale)
    else:
        assert state.ef is None and want_ef is None


def test_int8_ef_tracks_f32():
    """tests/test_overlap.py::TestErrorFeedback::test_int8_ef_tracks_f32,
    ported: over 60 SGD steps at n = 2, plain int8 exchange drifts from
    the f32 run and int8 + EF stays close. The dummy "z" param's constant
    gradient (50.0) sets the int8 scale of its ring chunk, so the mse
    gradients below about scale / 2 round to zero on the wire. The port's
    three final mses are held within 1e-3 of the reference's, run here on
    the same inputs, and to the reference test's gap assertions."""
    n, steps, lr = 2, 60, 0.05
    rng = np.random.RandomState(8)
    params = {"w": (rng.randn(64, 40) * 0.3).astype(np.float32),
              "z": np.zeros((128,), np.float32)}
    x = (rng.randn(n * 8, 64) * 0.3).astype(np.float32)
    y = (x @ (rng.randn(64, 40) * 0.3)).astype(np.float32)
    batch = {"x": x, "y": y}

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2) + 50.0 * p["z"][0]

    def tloss(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean() + 50.0 * p["z"][0]

    def mse(w):
        return float(np.mean((x @ np.asarray(w) - y) ** 2))

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    bsh = NamedSharding(mesh, P("data"))
    jb = {k: jax.device_put(v, bsh) for k, v in batch.items()}
    ref, port = [], []
    for quantized, ef in ((False, False), (True, False), (True, True)):
        opt = optax.sgd(lr)
        js = JZ.create_zero_state(jax.tree.map(jnp.asarray, params), opt,
                                  mesh, "data", error_feedback=ef)
        jstep = JZ.build_zero_train_step(jloss, opt, mesh, "data",
                                         collective=IMPL,
                                         quantized_grads=quantized,
                                         error_feedback=ef)
        topt = functools.partial(torch.optim.SGD, lr=lr)
        group = RingGroup(n, device="cpu")
        ts = create_zero_state({k: torch.from_numpy(v) for k, v in
                                params.items()}, topt, group,
                               error_feedback=ef)
        tstep = build_zero_train_step(tloss, topt, group,
                                      quantized_grads=quantized,
                                      error_feedback=ef)
        for _ in range(steps):
            js, _ = jstep(js, jb)
            ts, _ = tstep(ts, batch)
        ref.append(mse(js.params["w"]))
        port.append(mse(ts.params["w"].numpy()))
        if ef:
            assert ts.ef.dtype == torch.float32
            assert torch.isfinite(ts.ef).all() and ts.ef.abs().max() > 0
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-3)
    mf, mq, me = port
    gap_q, gap_e = mq - mf, me - mf
    assert gap_q > 0.04, (mf, mq, me)
    assert gap_e < 0.6 * gap_q, (mf, mq, me)
    assert me < mq


def test_state_and_options_are_checked():
    params, batch = _linear(4, 13, 7, 4)
    group = RingGroup(2, device="cpu")
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    with pytest.raises(ValueError, match="n_chunks"):
        build_zero_train_step(_tloss, opt, group, n_chunks=0)
    state = create_zero_state({k: torch.from_numpy(v) for k, v in
                               params.items()}, opt, group)
    state, _ = build_zero_train_step(_tloss, opt, group)(state, batch)
    # The optimizer's state layout is fixed by the first step.
    with pytest.raises(ValueError, match="toggle"):
        build_zero_train_step(_tloss, opt, group, overlap=True)(state, batch)
    with pytest.raises(ValueError, match="factory"):
        build_zero_train_step(_tloss, torch.optim.Adam, group)(state, batch)
    with pytest.raises(ValueError, match="RingGroup"):
        build_zero_train_step(_tloss, opt, RingGroup(2, device="cpu"))(
            state, batch)
    with pytest.raises(ValueError, match="split"):
        build_zero_train_step(_tloss, opt, group)(
            state, {k: v[:3] for k, v in batch.items()})
    with pytest.raises(TypeError, match="dtype"):
        create_zero_state({"a": torch.zeros(3), "b": torch.zeros(3,
                          dtype=torch.float64)}, opt, group)
    # The monolithic step on the CPU launched no kernel.
    assert [k.launches for k in R.KERNELS] == [0, 0, 0, 0]
    assert [k.launches for k in Q.KERNELS] == [0, 0]
    # The error-feedback buffer: f32, zeroed, one padded row per rank.
    ef_state = create_zero_state({k: torch.from_numpy(v) for k, v in
                                  params.items()}, opt, group,
                                 error_feedback=True)
    assert ef_state.ef.dtype == torch.float32
    assert ef_state.ef.shape == ef_state.flat.shape
    assert ef_state.ef.shape[1] % (2 * 128) == 0
    assert ef_state.ef.abs().max().item() == 0.0
