"""The port's ring collectives (``ray_tpu_torch.util.collective``) against
the JAX package's Pallas ring kernels, run as
``tests/test_pallas_collective.py`` runs them: ``impl="pallas_interpret"``
under ``shard_map`` over ``jax.devices()[:n]``.

Inputs come from numpy seeds; rank r's shard is row r of the host array on
both sides. The port's plain ring versions (what ``auto`` runs on a CPU
tensor) follow the reference's hop schedule element for element, and
every combine is one f32 operation on both sides, so every case is held
bit for bit (``assert_array_equal``): allreduce sum, max, min, prod and
avg (avg divides the ring sum by n on both sides), allgather,
reduce-scatter with a ragged slab (per-slab padding), permute, and the
split-phase forms against the monolithic ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ray_tpu.util.collective import pallas as J  # noqa: E402
from ray_tpu_torch.util import collective as T  # noqa: E402
from ray_tpu_torch.util.collective import ring as R  # noqa: E402

IMPL = "pallas_interpret"


def _jax(fn, host, n):
    """fn over each rank's shard, as the reference runs it (rank-major
    result: row r is rank r's output)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    g = jax.jit(shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                          in_specs=P("x"), out_specs=P("x"),
                          check_rep=False))
    return np.asarray(g(host))


def _port(out):
    return out.numpy()


def _host(seed, *shape, op="sum"):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if op == "prod":
        x = 1.0 + 0.1 * x        # products of a few factors near 1
    return x


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_allreduce_matches_reference(n, op):
    # 5 x 7 per rank: the LANES padding path.
    host = _host(10 + n, n, 5, 7, op=op)
    want = _jax(lambda x: J.ring_allreduce(x, "x", n=n, op=op, impl=IMPL),
                host, n)
    got = T.ring_allreduce(torch.from_numpy(host), op)
    np.testing.assert_array_equal(_port(got), want)


def _int_host(seed, *shape, op="sum"):
    # prod: factors in [-3, 3] (small products); the rest span int32 so
    # sums wrap around 2**32 on both sides.
    rng = np.random.RandomState(seed)
    if op == "prod":
        return rng.randint(-3, 4, shape).astype(np.int32)
    return rng.randint(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
        np.int32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_int32_allreduce_matches_reference(n, op):
    """int32 blocks (the reference's ring takes int blocks): exact in any
    order, so bit for bit, with wrap-around sums."""
    host = _int_host(60 + n, n, 5, 7, op=op)
    want = _jax(lambda x: J.ring_allreduce(x, "x", n=n, op=op, impl=IMPL),
                host, n)
    got = T.ring_allreduce(torch.from_numpy(host), op)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(_port(got), want)


@pytest.mark.parametrize("n", [2, 4])
def test_int32_allgather_and_reduce_scatter_match_reference(n):
    host = _int_host(70 + n, n, n * 3, 50)
    want = _jax(lambda x: J.ring_allgather(x, "x", n=n, impl=IMPL), host, n)
    np.testing.assert_array_equal(
        _port(T.ring_allgather(torch.from_numpy(host))), want)
    want = _jax(lambda x: J.ring_reduce_scatter(x, "x", n=n, op="sum",
                                                impl=IMPL), host, n)
    got = T.ring_reduce_scatter(torch.from_numpy(host), "sum")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_port(got), want)


@pytest.mark.parametrize("n", [2, 4])
def test_allgather_matches_reference(n):
    host = _host(20 + n, n, 3, 50)
    want = _jax(lambda x: J.ring_allgather(x, "x", n=n, impl=IMPL), host, n)
    got = T.ring_allgather(torch.from_numpy(host))
    assert got.shape == (n, n, 3, 50)
    np.testing.assert_array_equal(_port(got), want)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduce_scatter_ragged_slab_matches_reference(op):
    # Each rank reduces (n * 3, 5, 7) and keeps its slab of 105 elements:
    # not a multiple of 128, so each slab is padded on its own.
    n = 4
    host = _host(30, n, n * 3, 5, 7)
    want = _jax(lambda x: J.ring_reduce_scatter(x, "x", n=n, op=op,
                                                impl=IMPL), host, n)
    got = T.ring_reduce_scatter(torch.from_numpy(host), op)
    assert got.shape == (n, 3, 5, 7)
    np.testing.assert_array_equal(_port(got), want)


def test_permute_matches_reference():
    n = 4
    host = _host(40, n, 3, 50)

    def perm(x):
        return J.wait_ring_permute(J.start_ring_permute(x, "x", n=n,
                                                        impl=IMPL))

    want = _jax(perm, host, n)
    got = T.wait_ring_permute(T.start_ring_permute(torch.from_numpy(host)))
    np.testing.assert_array_equal(_port(got), want)
    np.testing.assert_array_equal(want, np.roll(host, 1, axis=0))


def test_split_phase_matches_monolithic_and_reference():
    """After tests/test_overlap.py:59-110: start + wait replays the
    monolithic hop schedule, so the results are equal bit for bit."""
    n = 4
    x = (np.arange(n * n * 8 * 128, dtype=np.float32) / 100.0).reshape(
        n, n * 8, 128)
    xt = torch.from_numpy(x)

    mono = T.ring_reduce_scatter(xt)
    split = T.wait_ring_reduce_scatter(T.start_ring_reduce_scatter(xt))
    np.testing.assert_array_equal(split.numpy(), mono.numpy())

    def jsplit(v):
        return J.wait_ring_reduce_scatter(
            J.start_ring_reduce_scatter(v, "x", n=n, impl=IMPL))

    np.testing.assert_array_equal(split.numpy(), _jax(jsplit, x, n))

    shards = xt[:, :8]
    mono = T.ring_allgather(shards)
    split = T.wait_ring_allgather(T.start_ring_allgather(shards))
    np.testing.assert_array_equal(split.numpy(), mono.numpy())
    for r in range(n):          # gather of the shards = the shards
        np.testing.assert_array_equal(split[r].numpy(), shards.numpy())


def test_donated_and_out_forms_match():
    n = 4
    x = torch.from_numpy(_host(50, n, n * 2, 128))
    want = T.ring_reduce_scatter(x)
    donated = x.clone()
    np.testing.assert_array_equal(
        T.ring_reduce_scatter(donated, donate=True).numpy(), want.numpy())
    shards = torch.from_numpy(_host(51, n, 2, 128))
    out = torch.zeros((n, n, 2, 128))
    assert T.ring_allgather(shards, out=out) is out
    np.testing.assert_array_equal(out.numpy(),
                                  T.ring_allgather(shards).numpy())
    h = T.start_ring_allgather(shards, out=torch.zeros((n, n, 2, 128)))
    np.testing.assert_array_equal(T.wait_ring_allgather(h).numpy(),
                                  out.numpy())


def test_bf16_plain_ring_rounds_once_per_hop():
    """bf16: each hop rounds one f32 combine to bf16, as ``a + b`` on two
    bf16 tensors does; the result is that chain of adds in ring order."""
    n = 4
    x = torch.from_numpy(_host(60, n, n, 128)).bfloat16()
    got = T.ring_allreduce(x)
    # Chunk c leaves rank c at hop 0 and collects ranks c + 1, c + 2, ...
    # in ring order during the reduce-scatter sweep.
    for c in range(n):
        order = [(c + i) % n for i in range(n)]
        acc = x[order[0], c]
        for r in order[1:]:
            acc = acc + x[r, c]
        assert torch.equal(got[0, c], acc)
    assert all(torch.equal(got[r], got[0]) for r in range(n))


_FOLD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16, "int32": torch.int32}
_FOLD_COMBINE = {"sum": lambda a, b: a + b, "prod": lambda a, b: a * b,
                 "max": torch.maximum, "min": torch.minimum}


def _fold_input(seed, n, c, dtype, op):
    """[n, n * c, 128] of ``dtype`` where the order of a fold shows: for
    floats, magnitudes 1e-3, 1 and 1e3 mixed element by element (prod:
    factors in about [0.4, 2.5] of either sign, so products of up to 8 stay
    finite in f16); int32 as ``_int_host``."""
    shape = (n, n * c, 128)
    if dtype == torch.int32:
        return torch.from_numpy(_int_host(seed, *shape, op=op))
    rng = np.random.RandomState(seed)
    if op == "prod":
        x = np.exp(0.3 * rng.randn(*shape)) * rng.choice([-1.0, 1.0], shape)
    else:
        x = rng.randn(*shape) * 10.0 ** rng.choice([-3, 0, 3], shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _fold_chunks(x, op, order):
    """[n, c, 128]: row k is chunk k folded over the ranks in ``order(k)``:
    acc = x[first][k], then acc = T(combine(x[p][k], acc))."""
    n, c = x.shape[0], x.shape[1] // x.shape[0]
    rows = []
    for k in range(n):
        ranks = order(k)
        sl = slice(k * c, (k + 1) * c)
        acc = x[ranks[0], sl]
        for p in ranks[1:]:
            acc = _FOLD_COMBINE[op](x[p, sl], acc)
        rows.append(acc)
    return torch.stack(rows)


def _fold(x, op, order):
    """Every rank's chunk c = the fold of chunk c over the ranks in
    ``order(c)`` (``_fold_chunks``)."""
    n = x.shape[0]
    return _fold_chunks(x, op, order).reshape(1, -1, 128).expand(n, -1, -1)


@pytest.mark.parametrize("dtype", list(_FOLD_DTYPES))
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_allreduce_is_the_ordered_fold_c4_pushes(n, op, dtype):
    """C4's contract: ``ring_allreduce_plain`` (the reference's two sweeps,
    hop by hop) leaves chunk c on every rank as acc = x_c[c], then acc =
    T(combine(x_{c+j}[c], acc)) for j = 1 .. n - 1, rounded to the element
    type after every step; C4 computes exactly that fold in one pass. Bit
    for bit. Where order can matter (a float sum or product over 3 or more
    ranks) the fold in the other direction differs, so the inputs pin the
    order."""
    dt = _FOLD_DTYPES[dtype]
    x = _fold_input(1000 + 17 * n, n, 4, dt, op)
    got = R.ring_allreduce_plain(x, op)
    want = _fold(x, op, lambda k: [(k + j) % n for j in range(n)])
    assert torch.equal(got, want)
    if dt != torch.int32 and op in ("sum", "prod") and n >= 3:
        other = _fold(x, op, lambda k: [(k - j) % n for j in range(n)])
        assert not torch.equal(got, other)


@pytest.mark.parametrize("dtype", list(_FOLD_DTYPES))
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_reduce_scatter_is_the_ordered_fold_c2_computes(n, op, dtype):
    """C2's contract: ``ring_reduce_scatter_plain`` (the reference's n - 1
    shifted hops, hop by hop) leaves rank c with chunk c folded as acc =
    x_{c+1}[c], then acc = T(combine(x_{c+j}[c], acc)) for j = 2 .. n,
    rounded to the element type after every step: C4's fold started one
    rank later, ending with the owner's own element. C2 computes exactly
    that fold in one pass. Bit for bit; where order can matter (a float sum
    or product over 3 or more ranks) the fold started at x_c, as C4's,
    differs, so the inputs pin the start."""
    dt = _FOLD_DTYPES[dtype]
    x = _fold_input(2000 + 17 * n, n, 4, dt, op)
    got = R.ring_reduce_scatter_plain(x, op)
    want = _fold_chunks(x, op, lambda k: [(k + j) % n
                                          for j in range(1, n + 1)])
    assert torch.equal(got, want)
    if dt != torch.int32 and op in ("sum", "prod") and n >= 3:
        other = _fold_chunks(x, op, lambda k: [(k + j) % n for j in range(n)])
        assert not torch.equal(got, other)


def test_auto_on_cpu_takes_the_plain_version():
    assert T.select_impl("auto", torch.device("cpu")) == "plain"
    assert T.select_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert T.select_impl("plain", torch.device("cuda", 0)) == "plain"
    with pytest.raises(ValueError):
        T.select_impl("pallas")
    before = [k.launches for k in R.KERNELS]
    x = torch.from_numpy(_host(70, 4, 8, 128))
    np.testing.assert_array_equal(
        T.ring_allreduce(x).numpy(),
        R.ring_allreduce_plain(x.view(4, 8, 128), "sum").numpy())
    T.wait_ring_reduce_scatter(T.start_ring_reduce_scatter(x))
    assert [k.launches for k in R.KERNELS] == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    n = 4
    good = torch.zeros((n, n * 2, 128))
    for wrapper in R.KERNELS:
        with pytest.raises(TypeError, match="dtype"):
            wrapper(good.double())
        with pytest.raises(TypeError, match="dtype"):
            wrapper(good.to(torch.int64))
        with pytest.raises(ValueError, match="takes"):
            wrapper(torch.zeros((n, 8, 64)))
        with pytest.raises(ValueError, match="ranks"):
            wrapper(torch.zeros((1, 8, 128)))
        with pytest.raises(ValueError, match="ranks"):
            wrapper(torch.zeros((R.MAX_RANKS + 1, 2 * (R.MAX_RANKS + 1),
                                 128)))
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(good)
    with pytest.raises(ValueError, match="split"):
        R.ring_reduce_scatter_cuda(torch.zeros((n, 6, 128)))
    # An explicit kernel request on a CPU tensor raises; it never runs the
    # plain version in its place.
    with pytest.raises(ValueError, match="CUDA"):
        T.ring_allreduce(good, impl="cuda")
    with pytest.raises(ValueError, match="divisible"):
        T.ring_reduce_scatter(torch.zeros((n, 6, 3)))
    with pytest.raises(ValueError, match="reduce op"):
        T.ring_allreduce(good, "xor")


def test_reduce_op_enum_and_group_on_cpu():
    g = T.RingGroup(4, device="cpu")
    x = torch.from_numpy(_host(80, 4, 3, 5))
    np.testing.assert_array_equal(g.allreduce(x, T.ReduceOp.AVERAGE).numpy(),
                                  T.ring_allreduce(x, "avg").numpy())
    np.testing.assert_array_equal(g.allgather(x).numpy(),
                                  T.ring_allgather(x).numpy())
    xs = torch.from_numpy(_host(81, 4, 8, 5))
    np.testing.assert_array_equal(
        g.reducescatter(xs, T.ReduceOp.MAX).numpy(),
        T.ring_reduce_scatter(xs, "max").numpy())
    g.check()


@pytest.mark.parametrize("n", [2, 4, 8, R.MAX_RANKS])
def test_flag_rounds_per_call_and_monotonic_epochs(n, monkeypatch):
    """C2, C3 and C4 run one pass in one flag round, and each launch of
    C5 (either form) is one hop; C6 takes one round per hop. The epoch
    bases ``RingGroup._begin``
    gives a kind's launches grow across calls so that each call's rounds
    (base + 1 .. base + hops) lie above every earlier call's: the kernels
    never reset their flags."""
    assert R.hops("allgather", n) == R.hops("allreduce", n) == 1
    assert R.hops("permute", n) == R.hops("qhop", n) == 1
    assert R.hops("reduce_scatter", n) == R.hops("qrs_hop", n) == 1
    assert R.hops("qallreduce", n) == 2 * (n - 1)
    # _begin on the CPU: no stream to order, no timeout record to map.
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    g = T.RingGroup(n, device="cpu")
    g._err_dev, g._err_host_ptr = torch.zeros(1, dtype=torch.int32), 0
    for kind in R.KINDS:
        top = 0
        for _ in range(5):
            base = g._begin(kind, 0).base
            assert base + 1 > top
            top = base + R.hops(kind, n)
    # Kinds count their calls apart: each has its own flag table.
    assert g._begin("allgather", 0).base == 5
    assert g._begin("allreduce", 0).base == 5
    assert g._begin("qallreduce", 0).base == 5 * 2 * (n - 1)


@pytest.mark.parametrize("n", [2, 4, R.MAX_RANKS])
def test_group_holds_comm_slots_only_when_a_call_asks(n, monkeypatch):
    """C1-C4 ask for no comm slots (``ring.cu``'s ``ring_slot_bytes``,
    checked on the card by chip_smoke's ring build phase), and a group
    whose calls ask for none holds none. A call that asks (C5, C6) gets
    the slots, which the group keeps and grows to the largest call."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    g = T.RingGroup(n, device="cpu")
    g._err_dev, g._err_host_ptr = torch.zeros(1, dtype=torch.int32), 0
    for kind in ("permute", "reduce_scatter", "allgather", "allreduce"):
        assert g._begin(kind, 0).slots_ptr is None and g._slots is None
    small = g._begin("qhop", n * 4096).slots_ptr
    assert small is not None and g._slots.numel() == n * 4096
    assert g._begin("qallreduce", n * 1024).slots_ptr == small
    assert g._begin("allgather", 0).slots_ptr is None
    assert g._slots.numel() == n * 4096
    g._begin("qrs_hop", n * 8192)
    assert g._slots.numel() == n * 8192


@pytest.mark.parametrize("name", [
    "quantized_ring_allreduce", "start_quantized_ring_reduce_scatter",
    "wait_quantized_ring_reduce_scatter", "local_quantization_residual"])
def test_quantized_names_raise(name):
    """The int8 ring's names, stubs that raised before C5 and C6 were
    ported, now run: on zeros of 4 ranks x 128 elements (below the int8
    threshold, so the bf16 rung) each returns zeros of the reference's
    shape and dtype on the CPU, through no kernel."""
    x = torch.zeros(4, 128)
    if name == "quantized_ring_allreduce":
        out, shape = T.quantized_ring_allreduce(x), (4, 128)
    elif name == "local_quantization_residual":
        out = T.local_quantization_residual(x.view(4, 1, 128), 1)
        shape = (4, 1, 128)
    else:
        h = T.start_quantized_ring_reduce_scatter(x)
        out, shape = T.wait_quantized_ring_reduce_scatter(h), (4, 32)
    assert out.shape == shape and out.dtype == torch.float32
    assert not out.any()
