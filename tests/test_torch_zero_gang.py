"""ZeRO with one rank per process (``parallel.zero`` on a ``CudaGroup``,
``util.collective``'s ``cuda`` backend) on the CPU, where the group runs
the plain rings over the stack gathered through gloo.

- The split-phase rank calls of C1 (``start_hop("permute")``, and
  ``ring.py``'s ``start_ring_permute`` / ``wait_ring_permute`` with the
  group) and C5 in place (``start_hop("qrs_hop")``, its carry table
  included), hop by hop in actors of one cluster, against the in-process
  plain hops on the
  stacked rows (``ring_permute_plain``, ``ring_qrs_hop_plain``) bit for
  bit, and against the reference's ``_permute_block`` / ``_qrs_hop`` run in
  interpret mode under ``shard_map`` on the stacked rows, hop by hop from
  the same rows (C1 bit for bit; C5 as ``tests/test_torch_quantized.py``
  holds its one-hop split-phase form: the same scales and codes, and XLA
  rounds ``cur + q * scale`` as one FMA where the port rounds the product
  and the sum apart, so within 2**-23 of max|rows before| + max|result|).
- The ZeRO step at n = 2 and 4, ranks in actors, every route (monolithic,
  overlap, replicated, quantized, error feedback, quantized overlap):
  each rank's params, loss and grad norm after three steps bit for bit
  the virtual-rank ``build_zero_train_step`` on ``RingGroup(n, "cpu")``;
  the exact routes within 1e-5 of the JAX package's
  ``build_zero_train_step(..., collective="pallas_interpret")`` (Adam, as
  ``tests/test_torch_zero.py``), the quantized ones held as that file holds
  them (SGD; within 1e-5 on 99.9% of elements, everywhere within the int8
  bound).
- ``CudaTrainer`` gangs of two CPU workers (``CudaConfig(device="cpu")``),
  sharded and overlap: per-step losses bit for bit the one-worker
  ``mesh_axes={"data": 2}`` run, within ``TOL_LOSS`` of the JAX package's
  ``run_pod_training`` on the same routes from the same params; every
  rank's final params equal. ``{"data": 3}`` at W = 2 raises, naming both
  numbers.

One cluster for the module; every ``get`` has a timeout; every process
that computes a step runs torch on one thread, so the processes' bits
agree.
"""

import functools
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.parallel import zero as JZ  # noqa: E402
from ray_tpu.util.collective.pallas import quantized as JQ  # noqa: E402
from ray_tpu.util.collective.pallas import ring as JR  # noqa: E402
from ray_tpu_torch.parallel import (  # noqa: E402
    build_replicated_train_step, build_zero_train_step, create_zero_state,
)
from ray_tpu_torch.train import (  # noqa: E402
    CudaConfig, CudaTrainer, RunConfig, ScalingConfig, TrainingFailedError,
)
from ray_tpu_torch.util import collective as col  # noqa: E402
from ray_tpu_torch.util.collective import RingGroup  # noqa: E402
from ray_tpu_torch.util.collective import quantized as Q  # noqa: E402
from ray_tpu_torch.util.collective import ring as R  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
import test_torch_trainer as TT  # noqa: E402

TOL = 1e-5
ULP = 2.0 ** -23
IMPL = "pallas_interpret"
STEPS = 3
LR = 1e-2
# route: (build_zero_train_step keyword arguments, quantized)
ROUTES = {
    "mono": ({}, False),
    "overlap": ({"overlap": True, "n_chunks": 3}, False),
    "replicated": (None, False),
    "quantized": ({"quantized_grads": True}, True),
    "error_feedback": ({"quantized_grads": True, "error_feedback": True},
                       True),
    "quantized_overlap": ({"quantized_grads": True, "overlap": True,
                           "n_chunks": 3}, True),
}
GANG_ROUTES = {"sharded-2": {"weight_update": "sharded"},
               "overlap-2": {"overlap": True}}


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=0,
                              object_store_memory=256 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Rank:
    """A rank: joins groups with the options the test set, and runs what it
    is sent on one torch thread."""

    def __init__(self):
        torch.set_num_threads(1)
        self.options = {}

    def set_options(self, options):
        self.options = dict(options)
        return True

    def _init_collective(self, world_size, rank, backend, group_name):
        col.init_collective_group(world_size, rank, backend=backend,
                                  group_name=group_name, **self.options)
        return True

    def run(self, fn, *args):
        return fn(*args)


@pytest.fixture(scope="module")
def ranks(cluster):
    return [Rank.remote() for _ in range(4)]


_groups = {}
_names = itertools.count()


def _group(ranks, n):
    """One ``cuda`` group on the CPU per n for the module."""
    if n not in _groups:
        name = f"zero_gang{next(_names)}_{n}"
        ray_tpu_torch.get([a.set_options.remote({"device": "cpu"})
                           for a in ranks[:n]], timeout=60)
        col.create_collective_group(ranks[:n], n, list(range(n)),
                                    backend="cuda", group_name=name)
        _groups[n] = name
    return ranks[:n], _groups[n]


def _run(actors, fn, *args):
    """fn(rank, *args) on every rank, the results in rank order."""
    return ray_tpu_torch.get([a.run.remote(fn, r, *args)
                              for r, a in enumerate(actors)], timeout=120)


def _get_group(name):
    from ray_tpu_torch.util.collective.collective import _group_mgr

    return _group_mgr.get_group(name)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process while a test runs, as in the
    ranks, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rows(fn, host, n):
    """fn over each rank's row under shard_map, as the reference runs it."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    g = jax.jit(shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                          in_specs=P("x"), out_specs=P("x"),
                          check_rep=False))
    return np.asarray(g(host))


# --------------------------------------------------------- the two hops

def _rank_hops(r, name, host, qhost):
    """C1 on this rank's block (f32 and bf16), then every hop of C5 in
    place on this rank's buffer: the results and carry columns."""
    grp = _get_group(name)
    n = grp.world_size
    x = torch.from_numpy(host[r])
    out = torch.empty_like(x)
    hop = grp.start_hop("permute", x, out=out)
    grp.finish_hops([hop])
    # Through ring.py's split-phase permute: a 5 x 7 shard (padded).
    h = R.start_ring_permute(torch.from_numpy(host[r, :5, :7].copy()),
                             group=grp)
    got = {"c1": hop.result.clone(), "c1_into_out": hop.result is out,
           "c1_bf16": grp.start_hop("permute", x.bfloat16()).result,
           "c1_api": R.wait_ring_permute(h)}
    buf = torch.from_numpy(qhost[r].copy())
    carry = torch.full((n - 1, n), -1, dtype=torch.int64)
    hops, carries = [], []
    for t in range(n - 1):
        h = grp.start_hop("qrs_hop", buf, t=t, carry=carry)
        grp.finish_hops([h])
        hops.append(buf.clone())
        carries.append(carry[:, r].clone())
    got.update(c5=hops, carry=carries)
    return got


@pytest.mark.parametrize("n", [2, 4])
def test_rank_hops_match_plain_and_reference(ranks, n):
    actors, name = _group(ranks, n)
    rows = 3
    host = np.random.RandomState(40 + n).randn(n, rows, 128).astype(
        np.float32)
    qhost = np.random.RandomState(50 + n).randn(n, n * rows, 128).astype(
        np.float32)
    qhost[1 % n, :rows] = 0.0          # a chunk at the scale floor
    got = _run(actors, _rank_hops, name, host, qhost)

    stack = torch.from_numpy(host)
    plain = R.ring_permute_plain(stack)
    plain_bf16 = R.ring_permute_plain(stack.bfloat16())
    ref = _jax_rows(lambda x: JR._permute_block(x, "x", n, True), host, n)
    api = R.wait_ring_permute(R.start_ring_permute(
        torch.from_numpy(host[:, :5, :7].copy())))
    for r in range(n):
        assert got[r]["c1_into_out"]
        assert torch.equal(got[r]["c1"], plain[r])
        assert torch.equal(got[r]["c1_api"], api[r])
        assert torch.equal(got[r]["c1_bf16"], plain_bf16[r])
        np.testing.assert_array_equal(got[r]["c1"].numpy(), ref[r])

    x = torch.from_numpy(qhost.copy())
    carry = torch.zeros((n - 1, n), dtype=torch.int64)
    for t in range(n - 1):
        before = x.numpy().copy()
        Q.ring_qrs_hop_plain(x, t, carry)
        ref = _jax_rows(functools.partial(
            lambda tt, b: JQ._qrs_hop(b, tt, n, "x", True), t), before, n)
        # The same scales and codes on both sides; XLA fuses the
        # reference's cur + deq into an FMA on the CPU, where the port
        # rounds the product and the add apart.
        bound = ULP * (np.abs(before).max() + np.abs(ref).max())
        for r in range(n):
            assert torch.equal(got[r]["c5"][t], x[r]), (t, r)
            want_carry = torch.zeros(n - 1, dtype=torch.int64)
            for u in range(1, min(t + 2, n - 1)):
                want_carry[u] = carry[u, r]
            assert torch.equal(got[r]["carry"][t], want_carry), (t, r)
            err = np.abs(got[r]["c5"][t].numpy().astype(np.float64)
                         - ref[r])
            assert err.max() <= bound, (t, r, err.max(), bound)


# --------------------------------------------------------- the ZeRO step

def _linear(seed, n, d_in=64, d_out=40, scale=0.1):
    rng = np.random.RandomState(seed)
    params = {"w": (rng.randn(d_in, d_out) * scale).astype(np.float32),
              "b": np.zeros((d_out,), np.float32)}
    batch = {"x": rng.randn(n * 4, d_in).astype(np.float32),
             "y": rng.randn(n * 4, d_out).astype(np.float32)}
    return params, batch


def _tloss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def _jloss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _train(group, route, params, batch):
    """Three steps of ``route`` on ``group``: per rank held here, its
    flat params, ef and the metrics."""
    kw, quantized = ROUTES[route]
    opt = functools.partial(torch.optim.SGD if quantized
                            else torch.optim.Adam, lr=LR)
    state = create_zero_state({k: torch.from_numpy(v)
                               for k, v in params.items()}, opt, group,
                              error_feedback=bool(kw and kw.get(
                                  "error_feedback")))
    step = (build_replicated_train_step(_tloss, opt, group) if kw is None
            else build_zero_train_step(_tloss, opt, group, **kw))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"], m["grad_norm"]))
    return state, metrics


def _rank_train(r, name, route, params, batch):
    state, metrics = _train(_get_group(name), route, params, batch)
    return {"flat": state.flat[0].clone(), "size": state.size,
            "ef": None if state.ef is None else state.ef[0].clone(),
            "params": {k: v.clone() for k, v in state.params.items()},
            "metrics": metrics}


@functools.lru_cache(maxsize=None)
def _reference(route, n):
    """The JAX package's ZeRO step on the route (the replicated route: its
    ZeRO step, which the reference's allreduce route equals to 1e-5)."""
    kw, quantized = ROUTES[route]
    kw = dict(kw or {})
    params, batch = _linear(n, n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    opt = optax.sgd(LR) if quantized else optax.adam(LR)
    state = JZ.create_zero_state(
        jax.tree.map(jnp.asarray, params), opt, mesh, "data",
        error_feedback=kw.get("error_feedback", False))
    step = JZ.build_zero_train_step(_jloss, opt, mesh, "data",
                                    collective=IMPL, **kw)
    jb = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
          for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return ({k: np.asarray(v) for k, v in state.params.items()},
            None if state.ef is None else np.asarray(state.ef), metrics)


def _held_q(got, want, bound):
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= TOL).mean() >= 0.999, (err > TOL).sum()
    assert err.max() <= bound, (err.max(), bound)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("n", [2, 4])
def test_rank_zero_matches_virtual_and_reference(ranks, n, route):
    actors, name = _group(ranks, n)
    params, batch = _linear(n, n)
    got = _run(actors, _rank_train, name, route, params, batch)
    state, metrics = _train(RingGroup(n, device="cpu"), route, params, batch)
    for r in range(n):
        assert torch.equal(got[r]["flat"], state.flat[r]), r
        if state.ef is not None:
            assert torch.equal(got[r]["ef"], state.ef[r]), r
        for (gl, gn), (wl, wn) in zip(got[r]["metrics"], metrics):
            assert torch.equal(gl, wl) and torch.equal(gn, wn), r
    kw, quantized = ROUTES[route]
    want, want_ef, jm = _reference(route, n)
    if not quantized:
        for k in params:
            np.testing.assert_allclose(got[0]["params"][k].numpy(), want[k],
                                       rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            [(float(a), float(b)) for a, b in got[0]["metrics"]], jm,
            rtol=TOL, atol=TOL)
        return
    # Any scale on the wire is at most max|summed gradient| / 127.
    g = state.grads.abs().sum(0).max().item()
    max_scale = 4 * g / 127.0
    for k in params:
        _held_q(got[0]["params"][k].numpy(), want[k],
                LR * (n - 1) * max_scale * STEPS)
    if kw.get("error_feedback"):
        ef = torch.stack([got[r]["ef"] for r in range(n)])
        _held_q(ef[:, :got[0]["size"]].numpy(),
                want_ef.reshape(n, -1)[:, :got[0]["size"]], max_scale)


def test_rank_zero_refuses_what_its_group_cannot_run(ranks):
    actors, name = _group(ranks, 2)

    def bad(r, name):
        group = _get_group(name)
        params, batch = _linear(2, 2)
        opt = functools.partial(torch.optim.SGD, lr=LR)
        state = create_zero_state({k: torch.from_numpy(v)
                                   for k, v in params.items()}, opt, group)
        out = []
        for impl in ("cuda",):
            step = build_zero_train_step(_tloss, opt, group, collective=impl)
            try:
                step(state, batch)
            except ValueError as e:
                out.append(str(e))
        try:
            state.rank_params(1 - r)
        except ValueError as e:
            out.append(str(e))
        return out

    for r, texts in enumerate(_run(actors, bad, name)):
        assert "runs the plain ring" in texts[0]
        assert f"rank {1 - r} is not held here" in texts[1]


# --------------------------------------------------- the trainer's gang

def _gang_loop(config):
    """run_pod_training in a worker with the reference's params, on one
    torch thread; reports the per-step losses, the summary and every
    rank's final flat params through the gang's group."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.train import cuda_backend

    torch.set_num_threads(1)
    config = dict(config)
    ref = config.pop("reference_params")
    cuda_backend.init_params = (
        lambda cfg, seed=0, device=None: params_from_numpy(ref, cfg, device))
    losses, flats = [], []

    def finish(state):
        group = getattr(state, "group", None)
        if getattr(group, "rank_form", False):
            flats.extend(group.gather(state.flat[0]).unbind(0))
        else:
            flats.append(state.flat[0])

    summary = cuda_backend.run_pod_training(
        **config, report=lambda m: losses.append(m["loss"]), device="cpu",
        on_finish=finish)
    train.report({"losses": losses, "summary": summary,
                  "flats": [f.numpy() for f in flats]})


@pytest.fixture(scope="module")
def gang_reference():
    """The JAX package's run_pod_training on the two gang routes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    routes = {k: dict(v, mesh_axes={"data": 2})
              for k, v in GANG_ROUTES.items()}
    p = subprocess.run(
        [sys.executable, "-c", TT._REFERENCE, "2", json.dumps(TT.TINY),
         json.dumps(routes), str(TT.STEPS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=170)
    assert p.returncode == 0, p.stderr[-3000:]
    line = next(ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def tiny_params():
    from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from ray_tpu.models.llama import init_params

    tree = init_params(JaxLlamaConfig(**TT.TINY, dtype=jnp.float32),
                       jax.random.key(0))
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _fit(workers, route, tiny_params, tmp_path, **config):
    cfg = TT._tiny_config()
    kw = GANG_ROUTES[route]
    return CudaTrainer(
        _gang_loop, train_loop_config=dict(
            model_config=cfg, steps=TT.STEPS, reference_params=tiny_params,
            mesh_axes={"data": 2}, **config),
        scaling_config=ScalingConfig(num_workers=workers),
        cuda_config=CudaConfig(device="cpu", mesh_axes={"data": 2},
                               weight_update=kw.get("weight_update",
                                                    "replicated"),
                               overlap=kw.get("overlap", False)),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()


@pytest.mark.parametrize("route", list(GANG_ROUTES))
def test_cpu_gang_of_two_matches_one_worker(cluster, route, tiny_params,
                                            gang_reference, tmp_path):
    """Two workers, one rank each, against one worker of two virtual
    ranks: the same losses bit for bit, and the reference's within
    TOL_LOSS; every rank ends with the same params as the one worker's."""
    route_kw = GANG_ROUTES[route]
    gang = _fit(2, route, tiny_params, tmp_path / "gang",
                **{k: v for k, v in route_kw.items()})
    one = _fit(1, route, tiny_params, tmp_path / "one",
               **{k: v for k, v in route_kw.items()})
    got, want = gang.metrics, one.metrics
    assert len(got["losses"]) == TT.STEPS
    assert got["losses"] == want["losses"]
    np.testing.assert_allclose(got["losses"],
                               gang_reference[route]["losses"], rtol=0,
                               atol=TT.TOL_LOSS)
    assert got["summary"]["mesh"] == {"data": 2}
    assert got["summary"]["n_devices"] == 1
    assert got["summary"]["batch_size"] == want["summary"]["batch_size"]
    assert got["summary"]["weight_update"] == "sharded"
    assert sorted(got["summary"]) == gang_reference[route]["keys"]
    assert len(got["flats"]) == 2
    for flat in got["flats"]:
        np.testing.assert_array_equal(flat, want["flats"][0])


def test_cpu_gang_refuses_a_data_axis_it_does_not_fill(cluster, tiny_params,
                                                       tmp_path):
    with pytest.raises(TrainingFailedError,
                       match=r"'data': 3 does not match the 2 workers"):
        CudaTrainer(
            _gang_loop, train_loop_config=dict(
                model_config=TT._tiny_config(), steps=1,
                reference_params=tiny_params, mesh_axes={"data": 3}),
            scaling_config=ScalingConfig(num_workers=2),
            cuda_config=CudaConfig(device="cpu", weight_update="sharded"),
            run_config=RunConfig(storage_path=str(tmp_path))).fit()
