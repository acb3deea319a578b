"""The port's int8 ring (``ray_tpu_torch.util.collective.quantized``: the
plain versions of kernels C5 and C6, which ``auto`` runs on a CPU tensor)
against the JAX package's Pallas kernels, run as
``tests/test_pallas_collective.py`` runs them: ``impl="pallas_interpret"``
under ``shard_map`` over ``jax.devices()[:n]``.

Inputs come from numpy seeds; rank r's data is row r on both sides.

Tolerances:
- ``quantized_ring_allreduce`` (C6) at n = 2 and 4, C5's hop, the bf16
  rung and ``local_quantization_residual``: bit for bit. C6's accumulate
  rounds once (an FMA) in the port, and XLA fuses the reference's
  ``out + q * scale`` into one FMA on the CPU.
- C6 at n = 8 and the split-phase reduce-scatter: XLA on the CPU rounds
  some of the reference's adds once (fused) and others otherwise, by how
  it compiles each hop, where the port rounds C6's accumulate once and
  the split-phase add (a tensor op after C5) twice. So each element is
  held to one f32 rounding plus one int8 quantum per hop,
  ``(n - 1) * (2**-23 * max|want| + max scale)``, and at least 99.9% of
  elements to the rounding part alone. The one-hop split-phase
  reduce-scatter (n = 2) is held to the rounding part alone.
"""

import fractions

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ray_tpu.util.collective.pallas import quantized as JQ  # noqa: E402
from ray_tpu_torch.util.collective import RingGroup  # noqa: E402
from ray_tpu_torch.util.collective import quantized as TQ  # noqa: E402
from ray_tpu_torch.util.collective import ring as R  # noqa: E402

IMPL = "pallas_interpret"
ULP = 2.0 ** -23


def _jax(fn, host, n):
    """fn over each rank's shard, as the reference runs it (rank-major
    result: row r is rank r's output)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    g = jax.jit(shard_map(lambda x: fn(x[0])[None], mesh=mesh,
                          in_specs=P("x"), out_specs=P("x"),
                          check_rep=False))
    return np.asarray(g(host))


def _host(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _held_per_hop(got, want, hops, max_scale):
    """Each element within one f32 rounding and one int8 quantum per hop,
    and at least 99.9% of them within the rounding alone."""
    err = np.abs(got.astype(np.float64) - want)
    rounding = hops * ULP * np.abs(want).max()
    assert err.max() <= rounding + hops * max_scale, (err.max(), rounding)
    assert (err <= rounding).mean() >= 0.999, (err > rounding).sum()


def _max_scale(host):
    """An upper bound of every scale on the wire: max|partial sum| / 127."""
    return np.abs(host).sum(0).max() / 127.0


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", ["ragged", "lanes", "zeros", "avg"])
def test_qallreduce_matches_reference(n, case):
    # ragged: 40 x 50 per rank, padded to n * 128 (the LANES path).
    shape = (16, 128) if case == "lanes" else (40, 50)
    host = _host(40 + n, n, *shape)
    if case == "zeros":
        host[:] = 0.0       # every scale at the 1e-30 floor
    op = "avg" if case == "avg" else "sum"
    want = _jax(lambda x: JQ.quantized_ring_allreduce(x, "x", n=n, op=op,
                                                      impl=IMPL), host, n)
    got = TQ.quantized_ring_allreduce(torch.from_numpy(host), op).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if n <= 4 or case == "zeros":
        np.testing.assert_array_equal(got, want)
        return
    # n = 8: on the CPU, XLA rounds the accumulates of one or two chunks'
    # reduction chains otherwise than one FMA (which chunks varies with
    # the input); the rest are bit for bit.
    _held_per_hop(got, want, 2 * (n - 1),
                  _max_scale(host) / (n if op == "avg" else 1))


def test_qallreduce_rows_differ_as_the_reference():
    """Rank r keeps its reduced chunk r + 1 unquantized: the rows differ,
    and row r's chunk r + 1 is the sum of what the ring reduced there."""
    n = 4
    host = _host(7, n, 8 * n, 128)
    got = TQ.quantized_ring_allreduce(torch.from_numpy(host)).numpy()
    want = _jax(lambda x: JQ.quantized_ring_allreduce(x, "x", n=n,
                                                      impl=IMPL), host, n)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])
    c = got.shape[1] // n
    for r in range(n):
        mine = got[r, ((r + 1) % n) * c:((r + 1) % n + 1) * c]
        exact = host[:, ((r + 1) % n) * c:((r + 1) % n + 1) * c].sum(0)
        assert np.abs(mine - exact).max() <= (n - 1) * _max_scale(host)


@pytest.mark.parametrize("kind", ["precision", "small", "f64", "ring_of_one"])
def test_bf16_rung_matches_reference(kind):
    n = 1 if kind == "ring_of_one" else 4
    shape = (3, 50) if kind == "small" else (40, 50)
    host = _host(50, n, *shape)
    precision = "bf16" if kind == "precision" else "int8"
    jn = max(n, 1)
    want = _jax(lambda x: JQ._bf16_fallback(x, "x", jn, "sum", IMPL), host,
                jn) if n > 1 else host.astype(jnp.bfloat16).astype(
                    np.float32)
    x = torch.from_numpy(host)
    if kind == "f64":
        # f64 values that are f32 values: the reference's rung on them,
        # cast to f64.
        x, want = x.double(), want.astype(np.float64)
    got = TQ.quantized_ring_allreduce(x, precision=precision).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_ladder_raises():
    x = torch.zeros((2, 2048))
    with pytest.raises(TypeError, match="floating-point"):
        TQ.quantized_ring_allreduce(x.to(torch.int32))
    with pytest.raises(ValueError, match="sum/avg"):
        TQ.quantized_ring_allreduce(x, "max")
    with pytest.raises(ValueError, match="precision"):
        TQ.quantized_ring_allreduce(x, precision="fp8")
    with pytest.raises(TypeError, match="floating-point"):
        TQ.start_quantized_ring_reduce_scatter(x.to(torch.int32))
    with pytest.raises(ValueError, match="sum/avg"):
        TQ.start_quantized_ring_reduce_scatter(x, "prod")
    with pytest.raises(ValueError, match="divisible"):
        TQ.start_quantized_ring_reduce_scatter(torch.zeros((2, 3, 1024)))
    # The kernel wrappers take CUDA f32 blocks only.
    with pytest.raises(TypeError, match="float32"):
        TQ.ring_qallreduce_cuda(torch.zeros((2, 2, 128),
                                            dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        TQ.ring_qhop_cuda(torch.zeros((2, 2, 128)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_qhop_matches_reference(n):
    """C5's function: one fused hop, per rank one scale over its block."""
    host = _host(60 + n, n, 24, 128)
    host[1 % n, 5, 7] = 40.0        # one large value sets rank 1's scale
    want = _jax(lambda x: JQ._qhop_block(x, "x", n, True), host, n)
    got = TQ.ring_qhop_plain(torch.from_numpy(host)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("op", ["sum", "avg"])
def test_split_phase_reduce_scatter_matches_reference(n, op):
    # Each rank reduces (n * 12, 9, 11): 1188 elements per slab, not a
    # multiple of 128, so each slab is padded on its own.
    host = _host(70 + n, n, n * 12, 9, 11)

    def ref(x):
        return JQ.wait_quantized_ring_reduce_scatter(
            JQ.start_quantized_ring_reduce_scatter(x, "x", n=n, op=op,
                                                   impl=IMPL))

    want = _jax(ref, host, n)
    h = TQ.start_quantized_ring_reduce_scatter(torch.from_numpy(host), op)
    assert h.hops_done == 1
    got = TQ.wait_quantized_ring_reduce_scatter(h).numpy()
    assert got.shape == want.shape == (n, 12, 9, 11)
    _held_per_hop(got, want, n - 1,
                  _max_scale(host) / (n if op == "avg" else 1))
    if n == 2:
        # One hop: the same scales and codes on both sides. XLA fuses the
        # reference's ``cur + deq`` into an FMA on the CPU, where the port
        # rounds the product and the add apart: each element within the
        # product's rounding and the sum's, and no int8 quantum.
        err = np.abs(got.astype(np.float64) - want)
        assert err.max() <= ULP * (np.abs(host).max()
                                   + np.abs(want).max()), err.max()


def _rs_input(seed, n, rows, variant="randn"):
    """[n, n * rows, 128] f32 for the in-place hop: randn, or with rank 1's
    chunk 0 all zero (every hop of it at the 1e-30 scale floor)."""
    x = _host(seed, n, n * rows, 128)
    if variant == "zero_chunk":
        x[1 % n, :rows] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("variant", ["randn", "zero_chunk"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_inplace_hop_is_the_split_phase_hop(n, variant):
    """C5's in-place form's plain version, at every hop t, equals the
    split-phase hop it replaces, ``_rs_hop`` around C5's standalone form
    (gather, hop, add, index-put), bit for bit; and each rank's received
    chunk equals ``cur + q * scale`` written out per rank: the sender's
    chunk quantized with the sender's one scale, the product and the sum
    each rounded to f32 (two roundings, as the tensor add)."""
    rows = 3
    x = _rs_input(130 + n, n, rows, variant)
    route = x.clone()
    for t in range(n - 1):
        before = x.clone()
        assert TQ.ring_qrs_hop_plain(x, t) is x
        R._rs_hop(route.view(n, n, rows, 128), t, "sum", TQ.ring_qhop_plain)
        assert torch.equal(x, route)
        for p in range(n):
            j = (p - t - 2) % n
            sent = before[(p - 1) % n, j * rows:(j + 1) * rows]
            scale = TQ._scale(sent)
            deq = TQ._codes(sent, scale) * scale
            want = before[p, j * rows:(j + 1) * rows] + deq
            assert torch.equal(x[p, j * rows:(j + 1) * rows], want)


@pytest.mark.parametrize("variant", ["randn", "zero_chunk"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_inplace_hop_carries_the_next_hops_max(n, variant):
    """What hop t carries (row t + 1 of the carry table, rank r's word
    tagged t + 1) is the max that ``_scale`` takes of hop t + 1's send
    chunk, r - t - 2, the chunk hop t wrote: so the scale hop t + 1 makes
    from it is ``_scale``'s of that chunk, bit for bit. Row 0 stays zero
    (hop 0 takes a max pass) and the last hop carries nothing."""
    rows = 3
    x = _rs_input(140 + n, n, rows, variant)
    carry = torch.zeros((n - 1, n), dtype=torch.int64)
    for t in range(n - 1):
        TQ.ring_qrs_hop_plain(x, t, carry)
        if t + 2 >= n:
            continue
        for r in range(n):
            word = int(carry[t + 1, r])
            assert word >> 32 == t + 1
            m = torch.tensor([word & 0xffffffff], dtype=torch.int64).to(
                torch.int32).view(torch.float32)[0]
            j = (r - (t + 1) - 1) % n          # hop t + 1's send chunk
            nxt = x[r, j * rows:(j + 1) * rows]
            assert torch.equal(m, TQ._absmax(nxt))
            assert torch.equal(TQ._scale_of(m), TQ._scale(nxt))
    assert not carry[0].any()
    assert carry.count_nonzero() == n * max(n - 2, 0)


def test_interleaved_handles_match_sequential():
    """The overlap path issues chunk c + 1's first hop before it waits for
    chunk c (``parallel/zero.py``): reduce-scatters in flight together,
    each with its own carry, give what they give one after another."""
    n = 4
    xs = [_rs_input(150 + i, n, 2 + i) for i in range(3)]
    seq = [TQ.wait_quantized_ring_reduce_scatter(
        TQ.start_quantized_ring_reduce_scatter(x)) for x in xs]
    hs = [TQ.start_quantized_ring_reduce_scatter(xs[0])]
    got = []
    for c in range(len(xs)):
        if c + 1 < len(xs):
            hs.append(TQ.start_quantized_ring_reduce_scatter(xs[c + 1]))
        got.append(TQ.wait_quantized_ring_reduce_scatter(hs[c]))
    for a, b in zip(got, seq):
        assert torch.equal(a, b)


def test_inplace_hop_wrapper_refuses_without_its_carry():
    """The in-place form's wrapper raises on a hop outside the
    reduce-scatter, without the reduce-scatter's carry table, and on a CPU
    tensor; it never takes a max pass in place of a missing carry."""
    n = 4
    x = torch.zeros((n, n * 2, 128))
    carry = torch.zeros((n - 1, n), dtype=torch.int64)
    with pytest.raises(ValueError, match="hop"):
        TQ.ring_qrs_hop_cuda(x, n - 1, carry)
    with pytest.raises(ValueError, match="carry"):
        TQ.ring_qrs_hop_cuda(x, 1, None)
    with pytest.raises(ValueError, match="carry"):
        TQ.ring_qrs_hop_cuda(x, 1, carry[:, :2])
    with pytest.raises(ValueError, match="CUDA"):
        TQ.ring_qrs_hop_cuda(x, 1, carry)
    with pytest.raises(TypeError, match="float32"):
        TQ.ring_qrs_hop_cuda(x.double(), 1, carry)


def test_split_phase_bf16_rung_matches_reference():
    n = 4
    host = _host(80, n, n * 2, 50)      # 100 elements per rank
    want = _jax(lambda x: JQ.wait_quantized_ring_reduce_scatter(
        JQ.start_quantized_ring_reduce_scatter(x, "x", n=n, impl=IMPL)),
        host, n)
    got = TQ.wait_quantized_ring_reduce_scatter(
        TQ.start_quantized_ring_reduce_scatter(torch.from_numpy(host)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,rows", [(2, 16), (4, 32), (4, 4)])
def test_local_quantization_residual_matches_reference(n, rows):
    # (4, 4): 512 elements per rank, below _MIN_QUANT_ELEMS: bf16 round-off.
    host = _host(90 + n + rows, n, rows, 128) * 3.0
    want = np.stack([np.asarray(JQ.local_quantization_residual(
        jnp.asarray(b), n)) for b in host])
    got = TQ.local_quantization_residual(torch.from_numpy(host), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full_like(got, 7.0)
    TQ.local_quantization_residual(torch.from_numpy(host), n, out=out)
    assert torch.equal(out, got)
    with pytest.raises(ValueError, match="divisible"):
        TQ.local_quantization_residual(torch.from_numpy(host[:, :3]), n)


def test_ring_group_quantized_allreduce():
    n = 4
    x = torch.from_numpy(_host(100, n, 40, 50))
    group = RingGroup(n, device="cpu")
    assert torch.equal(group.allreduce(x, quantized=True),
                       TQ.quantized_ring_allreduce(x))
    assert torch.equal(group.allreduce(x), R.ring_allreduce(x))


def test_plain_c6_in_place_and_pieces(monkeypatch):
    """In place (out is x) and with the chunks cut into pieces of two
    rows, the plain C6 gives the same bits."""
    n = 4
    x = torch.from_numpy(_host(110, n, 8 * n, 128))
    want = TQ.ring_qallreduce_plain(x)
    monkeypatch.setattr(TQ, "_PIECE", 2 * 128)
    y = x.clone()
    assert TQ.ring_qallreduce_plain(y, out=y) is y
    assert torch.equal(y, want)


def test_fma_rounds_once():
    """The plain C6's accumulate equals the exactly rounded a + q * s,
    also where the f64 add cannot hold the sum: q * s an f32 midpoint
    (3 * (1 + 2**-23) = 3 + 1.5 * 2**-22) and a tail of 2**-80, where a
    rounding through f64 alone would lose the tail and tie to even; and
    a sum 625 * 2**-62 below the midpoint 1 + 3 * 2**-24 whose f64
    rounding lies one f64 ulp below it (odd), where moving an inexact sum
    towards the exact value would land on the midpoint and tie up."""
    rng = np.random.RandomState(5)
    m = 4096
    q = rng.randint(-127, 128, m).astype(np.float32)
    s = (rng.rand(m) + 0.5).astype(np.float32)
    a = (rng.randn(m) * 10.0 ** rng.randint(-12, 3, m)).astype(np.float32)
    q[:2], s[:2] = 3.0, np.float32(1.0 + 2.0 ** -23)
    a[:2] = [2.0 ** -80, -(2.0 ** -80)]
    # (1 - 400u)(1 + 400u) 2**-24 = 2**-24 - 625 * 2**-62, u = 2**-23.
    q[2] = 1.0 - 400 * 2.0 ** -23
    s[2] = 2.0 ** -24 * (1.0 + 400 * 2.0 ** -23)
    a[2] = 1.0 + 2.0 ** -23
    got = TQ._fma(torch.from_numpy(q), torch.from_numpy(s),
                  torch.from_numpy(a))
    assert got[0].item() == 3.0 + 2.0 ** -21
    assert got[1].item() == 3.0 + 2.0 ** -22
    assert got[2].item() == 1.0 + 2.0 ** -23
    for i in range(m):
        exact = (fractions.Fraction(float(a[i]))
                 + fractions.Fraction(float(q[i]))
                 * fractions.Fraction(float(s[i])))
        assert got[i].item() == _round_f32(exact), i


def _round_f32(x: fractions.Fraction) -> float:
    """x rounded to the nearest f32, ties to even."""
    if x == 0:
        return 0.0
    lo = np.float32(float(x))           # within one f32 ulp of x
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    dist = [abs(fractions.Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    if len(ties) == 1:
        return float(ties[0])
    return float(next(c for c in ties
                      if np.frombuffer(np.float32(c).tobytes(),
                                       np.uint32)[0] % 2 == 0))


def test_no_kernel_launches_on_the_cpu():
    for k in TQ.KERNELS:
        k.launches = 0
    x = torch.from_numpy(_host(120, 4, 16, 128))
    TQ.quantized_ring_allreduce(x)
    TQ.wait_quantized_ring_reduce_scatter(
        TQ.start_quantized_ring_reduce_scatter(x))
    assert [k.launches for k in TQ.KERNELS] == [0, 0]
    assert TQ.select_impl("auto", x.device) == "plain"
