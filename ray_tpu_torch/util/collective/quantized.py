"""The int8 ring, kernels C5 and C6: the port of
``ray_tpu/util/collective/pallas/quantized.py`` (EQuARX-style quantized
ring allreduce) over n virtual ranks, rank-major as in ``ring.py``.

At every ring hop the outgoing f32 chunk is quantized to int8 with one
scale, ``max|chunk| / 127`` floored at 1e-30, rounded half to even and
clamped to +-127; the wire carries the codes and the scale, and the
receiver dequantizes. Each hop adds at most ``max|chunk| / 254`` of error
per element.

Kernels (``ops/csrc/ring.cu``):

- C6 ``ring_qallreduce_cuda`` (``_qar_kernel``): 2(n - 1) hops on
  x [n, n * c, LANES] f32, a reduce-scatter sweep that accumulates
  (``fma(q, scale, acc)``, rounded once, as the reference computes it),
  then an allgather sweep that overwrites with ``q * scale``. The ranks'
  rows are NOT equal: rank r keeps its reduced chunk r + 1 unquantized and
  gets every other chunk through at least one more int8 hop (its own
  chunk r comes back from its left neighbour requantized).
- C5, one kernel in two forms, one hop a launch:
  - ``ring_qhop_cuda`` (``_qhop_kernel``): one fused hop on
    x [n, rows, LANES] f32: ``out[r + 1] = dequant(quant(x[r]))`` with
    one scale over rank r's block;
  - ``ring_qrs_hop_cuda`` (the reference's ``_qrs_hop``): hop t of the
    split-phase int8 reduce-scatter in place on x [n, n * c, LANES] f32:
    rank r sends its chunk r - t - 1 and adds what arrives onto its chunk
    r - t - 2 (``cur + q * scale``, rounded twice, as the tensor add).
    Hop t + 1 sends the chunk hop t wrote, so hop t carries the max of
    what it writes to hop t + 1 in a table the reduce-scatter owns, and
    only hop 0 takes a max pass.
  Both count their launches on ``ring_qhop_cuda.launches``.

Beside each, a plain PyTorch version (``ring_qallreduce_plain``,
``ring_qhop_plain``, ``ring_qrs_hop_plain``) that follows the kernel's
schedule element for element: the same scales (max is exact), the same
codes (IEEE division, half-to-even rounding), and C6's accumulate
computed in f64 and rounded once to f32 (the product of an int8 code and
an f32 scale is exact in f64; an inexact f64 sum is rounded to odd, so
the f32 rounding is the FMA's). So the two agree bit for bit. The plain
versions work a rank and a piece of a chunk at a time, so their f64
temporaries stay small beside a large input.

Public functions (the reference's, with its fallback ladder):

- ``quantized_ring_allreduce(x, op, precision=, impl=, group=)``;
- ``start_quantized_ring_reduce_scatter`` / ``wait_quantized_ring_reduce_scatter``:
  the split-phase int8 reduce-scatter, one launch of C5's in-place form
  per hop (``_qrs_hop``: two roundings);
- ``local_quantization_residual(block, n)``: what a rank's data loses to
  its first int8 compression, for error feedback (plain tensor math).

Ladder: non-float input raises ``TypeError``; ops other than sum/avg and
an unknown precision raise ``ValueError``; f64 input, fewer than
``_MIN_QUANT_ELEMS`` elements per rank (``RAY_TPU_QAR_MIN_ELEMS``, default
1024), ``precision="bf16"`` or a ring of one take the bf16-compressed
exact ring (C4, or C2 for the reduce-scatter, on the card). ``auto`` runs
the kernels on a CUDA tensor and the plain int8 schedule on a CPU tensor
(the reference's ``pallas_interpret``); the reference's off-TPU ``lax``
rung has no counterpart. On the card a wrapper launches its kernel or
raises: nothing falls back.
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional

import torch

from ray_tpu_torch.util.collective import ring
from ray_tpu_torch.util.collective.ring import (
    LANES, SplitPhaseHandle, _bind, _check_block, _from_block, _group_for,
    _issue, _join, _launch, _norm_op, _own, _resume, _rot, _rs_block,
    _rs_hop, _to_block, select_impl,
)

# Below this many elements per rank the scale traffic dominates any wire
# savings (the reference's threshold, read from the same variable).
_MIN_QUANT_ELEMS = int(os.environ.get("RAY_TPU_QAR_MIN_ELEMS", "1024"))
_QMAX = 127.0
_FLOOR = 1e-30
# Elements per rank a plain version handles at once (f64 temporaries).
_PIECE = 1 << 22


def _pieces(t: torch.Tensor):
    """Views of a contiguous [rows, LANES] tensor, at most _PIECE elements
    each."""
    step = max(1, _PIECE // LANES)
    for i in range(0, t.shape[0], step):
        yield t[i:i + step]


def _absmax(chunk: torch.Tensor) -> torch.Tensor:
    """max|chunk| of a [rows, LANES] f32 chunk, a 0-dim f32 tensor."""
    return torch.stack([p.abs().amax() for p in _pieces(chunk)]).amax()


def _scale_of(m: torch.Tensor) -> torch.Tensor:
    """The kernels' scale of a chunk whose max|x| is m: ``max(m / 127,
    1e-30)``. The divisor is a tensor on m's device: torch divides by a
    host scalar on the card as a product with its reciprocal, which is not
    IEEE division."""
    qmax = torch.tensor(_QMAX, dtype=torch.float32, device=m.device)
    return (m / qmax).clamp_min(_FLOOR)


def _scale(chunk: torch.Tensor) -> torch.Tensor:
    """The kernels' scale of a [rows, LANES] f32 chunk, a 0-dim f32
    tensor."""
    return _scale_of(_absmax(chunk))


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 codes of x as f32: round half to even, clamp to +-127."""
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)


def _fma(q: torch.Tensor, scale: torch.Tensor, acc: torch.Tensor
         ) -> torch.Tensor:
    """``fma(q, scale, acc)`` rounded once to f32, for f32 tensors: the sum
    in f64 (the product is exact there) rounded to odd before the cast (an
    inexact sum with an even last bit moves one f64 ulp towards the exact
    value, found by a two-sum). A sum rounded to odd lands on no f32
    midpoint unless it is exact, so the f32 rounding is the FMA's."""
    p = q.double() * scale.double()
    a = acc.double()
    s = a + p
    bb = s - a
    err = (a - (s - bb)) + (p - bb)
    odd = (s.view(torch.int64) & 1) == 1
    inf = torch.tensor(math.inf, dtype=torch.float64, device=s.device)
    toward = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where((err == 0) | odd, s, toward).float()


def _qsend(src: torch.Tensor, dst: torch.Tensor, accumulate: bool) -> None:
    """One rank's leg of a quantized hop, in place: src [rows, LANES] is
    quantized with one scale and dequantized into dst (accumulated with
    one rounding, or overwritten)."""
    scale = _scale(src)
    for s, d in zip(_pieces(src), _pieces(dst)):
        q = _codes(s, scale)
        d.copy_(_fma(q, scale, d) if accumulate else q * scale)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def ring_qallreduce_plain(x: torch.Tensor,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C6's function on x [n, n * c, LANES] f32: returns [n, n * c, LANES]
    (into ``out`` if given; ``out`` may be x). The reference's schedule:
    in hop s of the reduce-scatter sweep rank r sends chunk r - s and its
    right neighbour accumulates it into its own chunk r - s; in hop s of
    the allgather sweep rank r sends chunk r - s + 1 and the neighbour
    overwrites its copy. Ranks go one at a time: within a hop no rank
    receives into the chunk it sends."""
    n, c = x.shape[0], x.shape[1] // x.shape[0]
    if out is None:
        out = x.clone()
    elif out.data_ptr() != x.data_ptr():
        out.copy_(x)
    o4 = out.view(n, n, c, LANES)
    for shift, accumulate in ([(-s, True) for s in range(n - 1)]
                              + [(1 - s, False) for s in range(n - 1)]):
        for r in range(n):
            j = (r + shift) % n
            _qsend(o4[r, j], o4[(r + 1) % n, j], accumulate)
    return out


def ring_qhop_plain(x: torch.Tensor) -> torch.Tensor:
    """C5's function on x [n, rows, LANES] f32: ``out[(r + 1) % n] =
    dequant(quant(x[r]))``, one scale per rank."""
    n = x.shape[0]
    out = torch.empty_like(x)
    for r in range(n):
        _qsend(x[r], out[(r + 1) % n], False)
    return out


def ring_qrs_hop_plain(x: torch.Tensor, t: int,
                       carry: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """C5's in-place form's function, on x [n, n * c, LANES] f32 in place
    (returned): hop t of the split-phase int8 reduce-scatter, ``_rs_hop``
    with C5's standalone function as the hop (the reference's
    ``_qrs_hop``): rank r quantizes its chunk r - t - 1 with one scale and
    sends it; its right neighbour adds the dequantized chunk onto its own
    chunk of that index, the product and the sum rounded apart. With
    ``carry`` ([n - 1, n] int64) it also writes what the kernel carries to
    hop t + 1 (t + 2 < n): row t + 1, rank r's word ``(t + 1) << 32 |``
    the bits of max|chunk r - t - 2| after the hop, hop t + 1's send
    chunk."""
    n = x.shape[0]
    x4 = x.view(n, n, -1, LANES)
    _rs_hop(x4, t, "sum", ring_qhop_plain)
    if carry is not None and t + 2 < n:
        m = torch.stack([_absmax(x4[r, (r - t - 2) % n]) for r in range(n)])
        carry[t + 1] = ((t + 1) << 32) | m.view(torch.int32).to(torch.int64)
    return x


# ---------------------------------------------------------------------------
# Kernels C5 and C6: launch wrappers with launch counters.
# ---------------------------------------------------------------------------

def _check_f32(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: unsupported dtype {x.dtype} (the int8 "
                        f"ring takes float32 only)")


def ring_qallreduce_cuda(x: torch.Tensor, *, group=None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch C6 on x [n, n * c, LANES] f32: returns [n, n * c, LANES]
    (into ``out`` if given; ``out=x`` runs in place). ``.launches`` counts
    launches."""
    _check_f32("ring_qallreduce_cuda", x)
    _check_block("ring_qallreduce_cuda", x, divisible=True)
    group = _group_for(x, group)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    elif out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(f"ring_qallreduce_cuda: out must be "
                         f"{tuple(x.shape)} {x.dtype}")
    else:
        _check_block("ring_qallreduce_cuda", out)
    _launch(group, "qallreduce", "sum", x, out,
            x.shape[1] // x.shape[0] * LANES)
    ring_qallreduce_cuda.launches += 1
    return out


ring_qallreduce_cuda.launches = 0


def ring_qhop_cuda(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Launch C5 on x [n, rows, LANES] f32: returns out with
    ``out[(r + 1) % n] = dequant(quant(x[r]))``. ``.launches`` counts
    launches of C5 in either form."""
    _check_f32("ring_qhop_cuda", x)
    _check_block("ring_qhop_cuda", x)
    group = _group_for(x, group)
    out = torch.empty((x.shape[0], x.shape[1], LANES), dtype=x.dtype,
                      device=x.device)
    _launch(group, "qhop", "sum", x, out, x.shape[1] * LANES)
    ring_qhop_cuda.launches += 1
    return out


ring_qhop_cuda.launches = 0


def ring_qrs_hop_cuda(x: torch.Tensor, t: int, carry: torch.Tensor, *,
                      group=None) -> torch.Tensor:
    """Launch C5's in-place form: hop t of the split-phase int8
    reduce-scatter on x [n, n * c, LANES] f32, in place (returned;
    ``ring_qrs_hop_plain``'s function). ``carry`` is the reduce-scatter's
    own table, [n - 1, n] int64 on x's device, which hop 0 zeroes
    (``_launch``, after the group's ordering), so a table may be reused:
    hop 0 takes its scale from a max pass, hop t > 0 from row t, which hop
    t - 1 filled; each hop but the last fills row t + 1. A carry that no
    hop t - 1 filled since the last hop 0 stops the kernel, and the group
    raises (``RingGroup.check``); there is no max pass in its place.
    Counts on ``ring_qhop_cuda.launches``: one kernel."""
    _check_f32("ring_qrs_hop_cuda", x)
    n = x.shape[0]
    if not 0 <= t < n - 1:
        raise ValueError(f"ring_qrs_hop_cuda: hop {t} of a reduce-scatter "
                         f"of {n - 1} hops")
    if carry is None or carry.shape != (n - 1, n) \
            or carry.dtype != torch.int64 or carry.device != x.device \
            or not carry.is_contiguous():
        raise ValueError(f"ring_qrs_hop_cuda needs the reduce-scatter's "
                         f"carry table, a contiguous [{n - 1}, {n}] int64 "
                         f"tensor on {x.device}")
    _check_block("ring_qrs_hop_cuda", x, divisible=True)
    group = _group_for(x, group)
    _launch(group, "qrs_hop", "sum", x, x, x.shape[1] // n * LANES, hop=t,
            carry=carry)
    ring_qhop_cuda.launches += 1
    return x


KERNELS = (ring_qhop_cuda, ring_qallreduce_cuda)


# ---------------------------------------------------------------------------
# The ladder.
# ---------------------------------------------------------------------------

def _check_args(x: torch.Tensor, op: Any, what: str, other: str) -> str:
    if not x.is_floating_point():
        raise TypeError(
            f"quantized {what} requires floating-point input, got "
            f"{x.dtype}: quantizing integer gradients silently corrupts "
            f"them (use {other} instead)")
    op = str(op).lower()
    if op not in ("sum", "avg", "mean"):
        raise ValueError(f"quantized {what} supports sum/avg, got {op!r}")
    return _norm_op(op)


def _wants_bf16(x: torch.Tensor) -> bool:
    return x.dtype == torch.float64 or x[0].numel() < _MIN_QUANT_ELEMS


def quantized_ring_allreduce(x: torch.Tensor, op: Any = "sum", *,
                             precision: str = "int8", impl: str = "auto",
                             group=None, donate: bool = False
                             ) -> torch.Tensor:
    """int8 quantize -> ring allreduce -> dequantize over the n ranks of
    x [n, ...]: returns [n, ...], row r rank r's result (rows differ in
    their int8 rounding; see the module docstring). Sum or avg (a sum
    divided by n after the ring). With ``donate`` an f32 x may be
    clobbered: the ring then runs in its memory."""
    op = _check_args(x, op, "allreduce", "ring_allreduce")
    if precision not in ("int8", "bf16"):
        raise ValueError(f"precision must be int8|bf16, got {precision!r}")
    n = x.shape[0]
    impl = select_impl(impl, x.device)
    if n == 1 or precision == "bf16" or _wants_bf16(x):
        out = ring.ring_allreduce(x.to(torch.bfloat16), op, impl=impl,
                                  group=group)
        return out.to(x.dtype)
    block, shape, size = _to_block(x.to(torch.float32), n)
    dst = block if donate or _own(block, x) else None
    if impl == "cuda":
        out = ring_qallreduce_cuda(block, group=group, out=dst)
    else:
        out = ring_qallreduce_plain(block, out=dst)
    result = _from_block(out, (n,), shape, size).to(x.dtype)
    return result / n if op == "avg" else result


def _qrs_hop(h: SplitPhaseHandle, t: int) -> None:
    """Hop t of an int8 reduce-scatter in flight: C5 in place on the card
    (the handle's carry table in meta), its plain version on the CPU."""
    if h.impl == "cuda":
        ring_qrs_hop_cuda(h.buf, t, h.meta[-1], group=h.group)
    else:
        ring_qrs_hop_plain(h.buf, t)


def start_quantized_ring_reduce_scatter(x: torch.Tensor, op: Any = "sum",
                                        *, impl: str = "auto", group=None,
                                        donate: bool = False
                                        ) -> SplitPhaseHandle:
    """Issue an int8 reduce-scatter of x [n, n * k, ...] (the contract of
    ``ring_reduce_scatter``, sum or avg): hop 0 (quantize, send,
    dequantize and add onto the receiving rank's chunk: one launch of C5's
    in-place form) now, the rest at the wait. On the card the handle owns
    the table that carries each hop's max to the next, so reduce-scatters
    in flight together on one stream keep theirs apart. With ``donate``
    an f32 x is clobbered. The bf16 rung only casts here; its ring runs
    at the wait."""
    op = _check_args(x, op, "reduce-scatter", "ring_reduce_scatter")
    n = x.shape[0]
    if x.dim() < 2 or x.shape[1] % n:
        raise ValueError(f"reduce_scatter: leading dim of each rank not "
                         f"divisible by ring size {n}")
    h = SplitPhaseHandle("quantized_reduce_scatter", n, op,
                         select_impl(impl, x.device))
    if n == 1 or _wants_bf16(x):
        h.meta = ("bf16", x.dtype, group)
        h.buf = x.to(torch.bfloat16)
        return h
    _bind(h, x, group)
    with _issue(h, x):
        xf = x.to(torch.float32)
        block, shape, per_shard = _rs_block(xf)
        if not (donate or _own(block, x)):
            block = block.clone()
        h.buf = block
        carry = (torch.empty((n - 1, n), dtype=torch.int64, device=x.device)
                 if h.impl == "cuda" else None)     # hop 0 zeroes it
        h.meta = ("int8", x.dtype, shape, per_shard, carry)
        _qrs_hop(h, 0)
    h.hops_done = 1
    return h


def wait_quantized_ring_reduce_scatter(h: SplitPhaseHandle) -> torch.Tensor:
    """Await ``start_quantized_ring_reduce_scatter``: the remaining hops
    (``_qrs_hop``'s schedule: rank r sends chunk r - t - 1 and adds what
    arrives to chunk r - t - 2), then [n, k, ...] with rank r's slab r in
    x's dtype."""
    n = h.n
    if h.meta[0] == "bf16":
        _, dtype, group = h.meta
        out = ring.ring_reduce_scatter(h.buf, h.op, impl=h.impl,
                                       group=group, donate=True)
        return out.to(dtype)
    b4 = h.buf.view(n, n, -1, LANES)
    with _resume(h):
        for t in range(h.hops_done, n - 1):
            _qrs_hop(h, t)
        ranks = _rot(n, 0, b4.device)
        mine = b4[ranks, ranks]
    h.hops_done = n - 1
    _join(h, mine)
    _, dtype, shape, per_shard, _ = h.meta
    out = _from_block(mine, (n,), shape, per_shard)
    if h.op == "avg":
        out = out / n
    return out.to(dtype)


def local_quantization_residual(block: torch.Tensor, n: int,
                                out: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """What each rank's data loses to its first int8 compression on the
    wire: ``block - dequant(quant(block))`` with one f32 scale per ring
    chunk (n per rank, the kernels' scale rule), always f32 (an int
    error-feedback buffer would requantize the correction itself).

    ``block`` is rank-major [R, rows, LANES] with rows % n == 0 (the
    reference takes one rank's [rows, LANES]). Below ``_MIN_QUANT_ELEMS``
    elements per rank the wire carries bf16, whose round-off is returned
    instead. Written into ``out`` if given; works a chunk piece at a time.
    """
    if block.dim() != 3 or block.shape[2] != LANES or block.shape[1] % n:
        raise ValueError(f"expected [ranks, rows, {LANES}] with rows "
                         f"divisible by {n}, got {tuple(block.shape)}")
    if out is None:
        out = torch.empty(block.shape, dtype=torch.float32,
                          device=block.device)
    elif out.shape != block.shape or out.dtype != torch.float32:
        raise ValueError(f"out must be {tuple(block.shape)} float32")
    if block[0].numel() < _MIN_QUANT_ELEMS:
        b = block.to(torch.float32)
        return torch.sub(b, b.to(torch.bfloat16).to(torch.float32), out=out)
    c = block.shape[1] // n
    for r in range(block.shape[0]):
        for j in range(n):
            src = block[r, j * c:(j + 1) * c].to(torch.float32)
            dst = out[r, j * c:(j + 1) * c]
            scale = _scale(src)
            for s, d in zip(_pieces(src), _pieces(dst)):
                torch.sub(s, _codes(s, scale) * scale, out=d)
    return out
