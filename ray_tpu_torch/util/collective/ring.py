"""Ring collectives C1-C4 over a ring of n virtual ranks: the port of
``ray_tpu/util/collective/pallas/ring.py`` (the int8 ring, C5 and C6, is
in ``quantized.py`` and shares this module's launch path).

The reference runs each kernel per device under ``shard_map``; here one
tensor holds every rank's data, rank-major: rank ``r``'s shard is
``x[r]``, in the layout of the reference's per-shard block. So
``ring_allreduce(x)`` takes ``x[n, ...]`` and returns ``[n, ...]`` with
every row the reduction, ``ring_allgather`` returns ``[n, n, ...]``,
``ring_reduce_scatter`` takes ``[n, n * k, ...]`` and returns
``[n, k, ...]`` (rank ``r`` keeps the reduced slab ``r``), and a permute
returns ``out[r] = x[r - 1]``.

Kernels (``ops/csrc/ring.cu``, one launch runs the ring protocol for all n
ranks at once, each rank played by its own thread blocks):

- C1 ``ring_permute_cuda``: one hop (``_permute_kernel``);
- C2 ``ring_reduce_scatter_cuda``: one ordered reduce of each rank's own
  chunk over the n ranks, stored once, one flag round
  (``_reduce_scatter_kernel``'s function: its n - 1 shifted hops leave
  chunk c on rank c folded as ``acc = x_{c+1}[c]``, then ``acc =
  combine(x_{c+j}[c], acc)`` for j = 2 .. n, rounded each step; the
  input is read, not written);
- C3 ``ring_allgather_cuda``: one read of each shard and a push of it to
  every rank, one flag round (``_allgather_kernel``'s function; its n - 1
  copy hops are not needed, since a copy has no combine order);
- C4 ``ring_allreduce_cuda``: one ordered reduce of each chunk over the
  n ranks, pushed to every rank, one flag round (``_allreduce_kernel``'s
  function: its two sweeps leave every rank chunk c folded as
  ``acc = x_c[c]``, then ``acc = combine(x_{c+j}[c], acc)`` for j = 1 ..
  n - 1, rounded each step; one pass computes that on one card).

Each takes the canonical block, ``[n, rows, 128]`` with each rank's block
contiguous (ranks may sit at any 16-byte aligned stride), and has a plain
PyTorch version beside it (``ring_*_plain``) that runs the same hop
schedule step by step on the rank-major tensor, so every element is
combined in the same order and the two agree bit for bit. Combines are
sum / max / min / prod; ``avg`` is a sum divided by n outside the kernel,
as in the reference.

Dispatch (``select_impl``): ``auto`` runs the kernel on a CUDA tensor and
the plain version on a CPU tensor, ``plain`` asks for the plain version
anywhere (the yardstick), ``cuda`` for the kernel. A kernel wrapper given
a CPU tensor, or a dtype, shape or layout it does not take, raises; a
refused launch or a ring that times out raises. Nothing falls back.

The split-phase forms (``start_*`` / ``wait_*``) run one hop per C1 launch
with the combine as a plain tensor op between hops, as the reference's
``_rs_hop`` does, so ``start + wait`` equals the monolithic kernel bit for
bit. On the card ``start_*`` enqueues hop 0 on the group's comm stream
after the current stream's work so far, ``wait_*`` enqueues the rest
there and makes the current stream wait for it; compute issued between
the two runs beside the hops.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.util.collective.types import ReduceOp

# The minor dim of every block (the reference's TPU lane count): one
# layout for both packages, so shards pad the same way.
LANES = 128
# Must match ring.cu (checked when the library loads).
MAX_RANKS = 16
MAX_BLOCKS_PER_RANK = 1024
# Flag table sections per rank: receive flags, capacity flags, and the
# per-rank barrier words of the int8 ring (C5, C6).
FLAG_SECTIONS = 3

# Kernel kinds, in ring.cu's numbering: C1-C4 here, C5 (two forms: qhop
# and the in-place reduce-scatter hop qrs_hop) and C6 (the int8 ring) in
# quantized.py.
KINDS = ("permute", "reduce_scatter", "allgather", "allreduce", "qhop",
         "qallreduce", "qrs_hop")
_OPS = {"sum": 0, "max": 1, "min": 2, "prod": 3}
# The block types C1-C4 take, in ring.cu's numbering: the reference's
# float and int blocks.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int32: 3}
_COMBINE = {
    "sum": lambda a, b: a + b,
    "max": torch.maximum,
    "min": torch.minimum,
    "prod": lambda a, b: a * b,
}
_REDUCE_OPS = {ReduceOp.SUM: "sum", ReduceOp.AVERAGE: "avg",
               ReduceOp.MIN: "min", ReduceOp.MAX: "max",
               ReduceOp.PRODUCT: "prod"}


def hops(kind: str, n: int) -> int:
    """Flag rounds (epochs) of one call of ``kind`` over n ranks: its ring
    hops, and one for C2's, C3's and C4's single passes."""
    return {"permute": 1, "reduce_scatter": 1, "allgather": 1,
            "allreduce": 1, "qhop": 1, "qallreduce": 2 * (n - 1),
            "qrs_hop": 1}[kind]


def select_impl(requested: str = "auto",
                device: Optional[torch.device] = None) -> str:
    """Resolve an implementation name for tensors on ``device``.

    ``auto`` -> ``cuda`` (the kernels) on a CUDA device, ``plain`` (the
    plain PyTorch versions) otherwise; explicit names pass through after
    validation. The reference's ``pallas`` / ``pallas_interpret`` / ``lax``
    map onto ``cuda`` / ``plain`` / (none: there is no library ring)."""
    valid = ("auto", "cuda", "plain")
    if requested not in valid:
        raise ValueError(f"impl must be one of {valid}, got {requested!r}")
    if requested != "auto":
        return requested
    dev = torch.device("cpu" if device is None else device)
    return "cuda" if dev.type == "cuda" else "plain"


def _norm_op(op: Any) -> str:
    if isinstance(op, ReduceOp):
        return _REDUCE_OPS[op]
    op = str(op).lower()
    if op == "mean":
        op = "avg"
    if op not in ("sum", "avg", "max", "min", "prod"):
        raise ValueError(f"unsupported reduce op {op!r}")
    return op


# ---------------------------------------------------------------------------
# The hop schedule: rank r's chunk index (r + shift) mod n, as index
# tensors on the data's device, cached.
# ---------------------------------------------------------------------------

_IDX: Dict[Tuple[str, int, int], torch.Tensor] = {}
_IDX_LOCK = threading.Lock()


def _rot(n: int, shift: int, device: torch.device) -> torch.Tensor:
    key = (str(device), n, shift % n)
    idx = _IDX.get(key)
    if idx is None:
        with _IDX_LOCK:
            idx = _IDX.get(key)
            if idx is None:
                idx = ((torch.arange(n) + shift) % n).to(device)
                _IDX[key] = idx
    return idx


def _rs_hop(x4: torch.Tensor, t: int, op: str, permute) -> None:
    """Reduce-scatter hop t on x4 [n, n, c, LANES], in place: the index
    schedule of the reference's ``_reduce_scatter_kernel`` step t (and of
    ``_rs_hop``): rank r sends chunk r - t - 1 and combines what its left
    neighbour sent into chunk r - t - 2."""
    n, dev = x4.shape[0], x4.device
    ranks = _rot(n, 0, dev)
    recv = _rot(n, -t - 2, dev)
    received = permute(x4[ranks, _rot(n, -t - 1, dev)])
    x4[ranks, recv] = _COMBINE[op](x4[ranks, recv], received)


def _ag_hop(o4: torch.Tensor, t: int, permute) -> None:
    """Allgather hop t on o4 [n, n, rows, LANES], in place: rank r sends
    slab r - t and stores its left neighbour's as slab r - t - 1."""
    n, dev = o4.shape[0], o4.device
    o4[_rot(n, 0, dev), _rot(n, -t - 1, dev)] = permute(
        o4[_rot(n, 0, dev), _rot(n, -t, dev)])


# ---------------------------------------------------------------------------
# Plain versions: the kernels' functions, hop by hop, in plain PyTorch.
# ---------------------------------------------------------------------------

def ring_permute_plain(x: torch.Tensor) -> torch.Tensor:
    """C1's function: ``out[(r + 1) % n] = x[r]``, one hop."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out[_rot(x.shape[0], 1, x.device)] = x
    return out


def ring_reduce_scatter_plain(x: torch.Tensor, op: str = "sum",
                              donate: bool = False) -> torch.Tensor:
    """C2's function on x [n, n * c, LANES]: n - 1 hops of the reference's
    shifted schedule; returns [n, c, LANES], rank r's reduced chunk r.
    With ``donate`` the hops accumulate in x itself (clobbered)."""
    n = x.shape[0]
    acc = x if donate else x.clone()
    a4 = acc.view(n, n, acc.shape[1] // n, LANES)
    for t in range(n - 1):
        _rs_hop(a4, t, op, ring_permute_plain)
    ranks = _rot(n, 0, x.device)
    return a4[ranks, ranks]


def ring_allgather_plain(x: torch.Tensor,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C3's function on x [n, rows, LANES]: returns [n, n * rows, LANES]
    (into ``out`` if given), rank r's slabs in rank order."""
    n, rows = x.shape[0], x.shape[1]
    if out is None:
        out = torch.empty((n, n * rows, LANES), dtype=x.dtype,
                          device=x.device)
    o4 = out.view(n, n, rows, LANES)
    ranks = _rot(n, 0, x.device)
    o4[ranks, ranks] = x
    for t in range(n - 1):
        _ag_hop(o4, t, ring_permute_plain)
    return out


def ring_allreduce_plain(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """C4's function on x [n, n * c, LANES]: the reference's reduce-scatter
    sweep (rank r sends chunk r - s, combines into r - s - 1), then its
    allgather sweep (sends r - s + 1, stores r - s)."""
    n = x.shape[0]
    out = x.clone()
    o4 = out.view(n, n, out.shape[1] // n, LANES)
    # Each sweep's hop s is the reduce-scatter's (allgather's) hop s - 1:
    # the reduce-scatter schedule is this one shifted by a hop.
    for s in range(n - 1):
        _rs_hop(o4, s - 1, op, ring_permute_plain)
    for s in range(n - 1):
        _ag_hop(o4, s - 1, ring_permute_plain)
    return out


# ---------------------------------------------------------------------------
# Kernels C1-C4: launch wrappers with launch counters.
# ---------------------------------------------------------------------------

_lib_cache: Dict[str, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    lib = _lib_cache.get("ring")
    if lib is not None:
        return lib
    from ray_tpu_torch.ops import _build

    lib = _build.load("ring")
    lib.ring_launch.restype = ctypes.c_int
    lib.ring_launch.argtypes = (
        [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    lib.ring_host_device_ptr.restype = ctypes.c_int
    lib.ring_host_device_ptr.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
    lib.ring_error_string.restype = ctypes.c_char_p
    lib.ring_error_string.argtypes = [ctypes.c_int]
    lib.ring_slot_bytes.restype = ctypes.c_longlong
    lib.ring_slot_bytes.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong]
    if (lib.ring_max_ranks(), lib.ring_max_blocks_per_rank(),
            lib.ring_flag_sections()) != (MAX_RANKS, MAX_BLOCKS_PER_RANK,
                                          FLAG_SECTIONS):
        raise RuntimeError("ring.cu and ring.py disagree on MAX_RANKS / "
                           "MAX_BLOCKS_PER_RANK / FLAG_SECTIONS")
    _lib_cache["ring"] = lib
    return lib


def _group_for(x: torch.Tensor, group):
    """The group that runs kernels on x: ``group`` (checked against x) or
    the default group of x's ring size and device."""
    from ray_tpu_torch.util.collective.group import default_group

    if group is None:
        return default_group(x.shape[0], x.device)
    if group.n != x.shape[0] or group.device != x.device:
        raise ValueError(f"tensor of {x.shape[0]} ranks on {x.device} "
                         f"given to a group of {group.n} on {group.device}")
    return group


def _check_block(name: str, x: torch.Tensor, divisible: bool = False
                 ) -> None:
    """Raise unless x is what the kernels take: f32, bf16, f16 or int32,
    [n, rows, LANES] with 2 <= n <= MAX_RANKS, on a CUDA device, each
    rank's block contiguous and 16-byte aligned, ranks not overlapping."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype} (float32, "
                        f"bfloat16, float16 and int32 only)")
    if x.dim() != 3 or x.shape[2] != LANES or x.shape[1] < 1:
        raise ValueError(f"{name} takes [n, rows, {LANES}], got "
                         f"{tuple(x.shape)}")
    n, rows = x.shape[0], x.shape[1]
    if not 2 <= n <= MAX_RANKS:
        raise ValueError(f"{name}: ring of {n} ranks (2..{MAX_RANKS})")
    if divisible and rows % n:
        raise ValueError(f"{name}: {rows} rows do not split into {n} "
                         f"chunks")
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.stride(2) != 1 or (rows > 1 and x.stride(1) != LANES):
        raise ValueError(f"{name}: each rank's block must be contiguous")
    if x.stride(0) < rows * LANES:
        raise ValueError(f"{name}: ranks overlap (stride {x.stride(0)})")
    if x.data_ptr() % 16 or (x.stride(0) * x.element_size()) % 16:
        raise ValueError(f"{name}: ranks must start 16-byte aligned")


def _launch(group, kind: str, op: str, x: torch.Tensor, out: torch.Tensor,
            chunk_elems: int, hop: int = 0,
            carry: Optional[torch.Tensor] = None) -> None:
    """Launch ``kind`` on the group's workspace; ``hop`` and ``carry`` are
    C5's in-place form's (the reduce-scatter's hop and carry table, which
    hop 0 zeroes on the launch's stream, after the group's ordering)."""
    lib = _lib()
    kind_code, dtype_code = KINDS.index(kind), _DTYPE_CODES[x.dtype]
    ws = group._begin(kind, lib.ring_slot_bytes(kind_code, x.shape[0],
                                                chunk_elems))
    if carry is not None and hop == 0:
        carry.zero_()
    with torch.cuda.device(x.device.index):
        err = lib.ring_launch(
            kind_code, _OPS[op], dtype_code, x.shape[0],
            x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
            chunk_elems, ws.slots_ptr, ws.flags_ptr, ws.base,
            ws.err_dev_ptr, ws.err_host_ptr, ws.stream.cuda_stream, hop,
            None if carry is None else carry.data_ptr())
    group._end(ws)
    if err != 0:
        raise RuntimeError(f"ring {kind} launch failed: "
                           f"{lib.ring_error_string(err).decode()} ({err})")


def ring_permute_cuda(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """Launch C1 on x [n, rows, LANES]: returns out with
    ``out[(r + 1) % n] = x[r]``. ``.launches`` counts launches."""
    _check_block("ring_permute_cuda", x)
    group = _group_for(x, group)
    out = torch.empty((x.shape[0], x.shape[1], LANES), dtype=x.dtype,
                      device=x.device)
    _launch(group, "permute", "sum", x, out, x.shape[1] * LANES)
    ring_permute_cuda.launches += 1
    return out


ring_permute_cuda.launches = 0


def ring_reduce_scatter_cuda(x: torch.Tensor, op: str = "sum", *,
                             group=None, donate: bool = False
                             ) -> torch.Tensor:
    """Launch C2 on x [n, n * c, LANES] (op sum, max, min or prod):
    returns [n, c, LANES], rank r's reduced chunk r. The kernel reads x
    and writes only the result, so ``donate`` (which lets the plain
    version and the split-phase forms run in x) changes nothing here.
    ``.launches`` counts launches."""
    _check_block("ring_reduce_scatter_cuda", x, divisible=True)
    group = _group_for(x, group)
    n, c = x.shape[0], x.shape[1] // x.shape[0]
    out = torch.empty((n, c, LANES), dtype=x.dtype, device=x.device)
    _launch(group, "reduce_scatter", op, x, out, c * LANES)
    ring_reduce_scatter_cuda.launches += 1
    return out


ring_reduce_scatter_cuda.launches = 0


def ring_allgather_cuda(x: torch.Tensor, *, group=None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch C3 on x [n, rows, LANES]: returns [n, n * rows, LANES]
    (into ``out`` if given), every rank's slabs in rank order.
    ``.launches`` counts launches."""
    _check_block("ring_allgather_cuda", x)
    group = _group_for(x, group)
    n, rows = x.shape[0], x.shape[1]
    if out is None:
        out = torch.empty((n, n * rows, LANES), dtype=x.dtype,
                          device=x.device)
    elif out.shape != (n, n * rows, LANES) or out.dtype != x.dtype:
        raise ValueError(f"ring_allgather_cuda: out must be "
                         f"{(n, n * rows, LANES)} {x.dtype}")
    _check_block("ring_allgather_cuda", out)
    _launch(group, "allgather", "sum", x, out, rows * LANES)
    ring_allgather_cuda.launches += 1
    return out


ring_allgather_cuda.launches = 0


def ring_allreduce_cuda(x: torch.Tensor, op: str = "sum", *,
                        group=None) -> torch.Tensor:
    """Launch C4 on x [n, n * c, LANES] (op sum, max, min or prod):
    returns [n, n * c, LANES], every rank the reduction.
    ``.launches`` counts launches."""
    _check_block("ring_allreduce_cuda", x, divisible=True)
    group = _group_for(x, group)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(group, "allreduce", op, x, out, x.shape[1] // x.shape[0] * LANES)
    ring_allreduce_cuda.launches += 1
    return out


ring_allreduce_cuda.launches = 0

KERNELS = (ring_permute_cuda, ring_reduce_scatter_cuda, ring_allgather_cuda,
           ring_allreduce_cuda)


def _permute_fn(impl: str, group):
    if impl == "cuda":
        return lambda t: ring_permute_cuda(t, group=group)
    return ring_permute_plain


# ---------------------------------------------------------------------------
# Shape adaptation: rank-major tensors of any shape <-> blocks.
# ---------------------------------------------------------------------------

def _to_block(x: torch.Tensor, multiple: int):
    """[n, ...] -> [n, rows, LANES] with rows % multiple == 0, each rank
    zero padded on its own (a view when nothing is padded)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    group = multiple * LANES
    padded = -(-size // group) * group
    if padded != size:
        flat = F.pad(flat, (0, padded - size))
    return flat.reshape(n, -1, LANES), tuple(x.shape[1:]), size


def _from_block(block: torch.Tensor, lead: Tuple[int, ...],
                shape: Tuple[int, ...], size: int) -> torch.Tensor:
    return block.reshape(*lead, -1)[..., :size].reshape(*lead, *shape)


def _rs_block(x: torch.Tensor):
    """Per-slab padding of a reduce-scatter input [n, n * k, ...] (the
    reference's ``ring.py:341-348``): each of the n slabs of a rank is
    padded on its own, so chunk i is exactly slab i. Returns (block
    [n, n * c, LANES], shard shape, elements per shard)."""
    n = x.shape[0]
    if x.dim() < 2 or x.shape[1] % n:
        raise ValueError(f"reduce_scatter: leading dim "
                         f"{x.shape[1] if x.dim() > 1 else None} of each "
                         f"rank not divisible by ring size {n}")
    shard_shape = (x.shape[1] // n,) + tuple(x.shape[2:])
    per_shard = math.prod(shard_shape)
    slabs = x.reshape(n, n, per_shard)
    padded = -(-per_shard // LANES) * LANES
    if padded != per_shard:
        slabs = F.pad(slabs, (0, padded - per_shard))
    return slabs.reshape(n, n * (padded // LANES), LANES), shard_shape, \
        per_shard


def _own(block: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether block is a fresh copy (not x's memory)."""
    return block.untyped_storage().data_ptr() != \
        x.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# Public rank-major collectives.
# ---------------------------------------------------------------------------

def ring_allreduce(x: torch.Tensor, op: Any = "sum", *, impl: str = "auto",
                   group=None) -> torch.Tensor:
    """Allreduce x [n, ...] over its n ranks (the reference's ``lax.psum``-
    shaped ``ring_allreduce``): returns [n, ...], every row the
    reduction. ``avg`` sums, then divides by n."""
    op = _norm_op(op)
    n = x.shape[0]
    impl = select_impl(impl, x.device)
    if n == 1:
        return x.clone()
    kernel_op = "sum" if op == "avg" else op
    block, shape, size = _to_block(x, n)
    if impl == "cuda":
        out = ring_allreduce_cuda(block, kernel_op, group=group)
    else:
        out = ring_allreduce_plain(block, kernel_op)
    out = _from_block(out, (n,), shape, size)
    return out / n if op == "avg" else out


def _gather_out(out: Optional[torch.Tensor], x: torch.Tensor, size: int,
                rows: int) -> Optional[torch.Tensor]:
    """The block view of a caller's allgather output [n, n, ...]."""
    if out is None:
        return None
    n = x.shape[0]
    if out.shape != (n, n) + tuple(x.shape[1:]) or out.dtype != x.dtype \
            or out.device != x.device:
        raise ValueError(f"allgather out must be {(n, n) + tuple(x.shape[1:])}"
                         f" {x.dtype} on {x.device}")
    if size != rows * LANES:
        raise ValueError("allgather into out needs shards of a multiple of "
                         f"{LANES} elements")
    return out.view(n, n * rows, LANES)


def ring_allgather(x: torch.Tensor, *, impl: str = "auto", group=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Allgather x [n, ...]: returns [n, n, ...], where ``[r, j]`` is rank
    j's shard on rank r (the reference's ``lax.all_gather``-shaped
    ``ring_allgather``). With ``out`` the result is written there."""
    n = x.shape[0]
    impl = select_impl(impl, x.device)
    if n == 1:
        res = x.unsqueeze(1)
        return out.copy_(res) if out is not None else res.clone()
    block, shape, size = _to_block(x, 1)
    rows = block.shape[1]
    ob = _gather_out(out, x, size, rows)
    if impl == "cuda":
        ob = ring_allgather_cuda(block, group=group, out=ob)
    else:
        ob = ring_allgather_plain(block, out=ob)
    if out is not None:
        return out
    return _from_block(ob, (n, n), shape, size)


def ring_reduce_scatter(x: torch.Tensor, op: Any = "sum", *,
                        impl: str = "auto", group=None,
                        donate: bool = False) -> torch.Tensor:
    """Reduce-scatter x [n, n * k, ...] along each rank's leading dim
    (the reference's ``psum_scatter(tiled=True)``-shaped
    ``ring_reduce_scatter``): returns [n, k, ...], rank r the reduced slab
    r. With ``donate`` the ring may accumulate in x's memory, which is
    then clobbered."""
    op = _norm_op(op)
    n = x.shape[0]
    impl = select_impl(impl, x.device)
    if n == 1:
        return x if donate else x.clone()
    kernel_op = "sum" if op == "avg" else op
    block, shape, per_shard = _rs_block(x)
    donate = donate or _own(block, x)
    if impl == "cuda":
        out = ring_reduce_scatter_cuda(block, kernel_op, group=group,
                                       donate=donate)
    else:
        out = ring_reduce_scatter_plain(block, kernel_op, donate=donate)
    out = _from_block(out, (n,), shape, per_shard)
    return out / n if op == "avg" else out


# ---------------------------------------------------------------------------
# Split-phase forms: one hop per C1 launch, issued early, awaited late.
# ---------------------------------------------------------------------------

class SplitPhaseHandle:
    """An in-flight split-phase ring collective. Every ``start_*`` must be
    balanced by the matching ``wait_*``; the handle holds the buffer the
    remaining hops run on (and, on the card, the comm stream)."""

    __slots__ = ("kind", "n", "op", "impl", "group", "stream", "buf",
                 "hops_done", "meta")

    def __init__(self, kind, n, op, impl):
        self.kind = kind
        self.n = n
        self.op = op
        self.impl = impl
        self.group = None
        self.stream = None
        self.buf = None
        self.hops_done = 0
        self.meta = None


def _bind(h: SplitPhaseHandle, x: torch.Tensor, group) -> None:
    if h.impl == "cuda":
        h.group = _group_for(x, group)
        h.stream = h.group.comm_stream


@contextlib.contextmanager
def _issue(h: SplitPhaseHandle, *tensors: torch.Tensor):
    """Run the body on the comm stream after the current stream's work so
    far; the tensors (made on the current stream) are in use there."""
    if h.stream is None:
        yield
        return
    cur = torch.cuda.current_stream(h.stream.device)
    h.stream.wait_stream(cur)
    for t in tensors:
        t.record_stream(h.stream)
    with torch.cuda.stream(h.stream):
        yield


@contextlib.contextmanager
def _resume(h: SplitPhaseHandle):
    """Run the body on the comm stream, after the hops issued there."""
    if h.stream is None:
        yield
        return
    with torch.cuda.stream(h.stream):
        yield


def _join(h: SplitPhaseHandle, result: torch.Tensor) -> None:
    """The current stream waits for the comm stream; result is used on
    the current stream from here."""
    if h.stream is None:
        return
    cur = torch.cuda.current_stream(h.stream.device)
    cur.wait_stream(h.stream)
    result.record_stream(cur)


def start_ring_reduce_scatter(x: torch.Tensor, op: Any = "sum", *,
                              impl: str = "auto", group=None,
                              donate: bool = False) -> SplitPhaseHandle:
    """Issue a reduce-scatter (the contract of ``ring_reduce_scatter``):
    hop 0 now, the rest at ``wait_ring_reduce_scatter``. With ``donate``
    the hops run in x's memory."""
    op = _norm_op(op)
    n = x.shape[0]
    h = SplitPhaseHandle("reduce_scatter", n, op, select_impl(impl, x.device))
    if n == 1:
        h.buf = x if donate else x.clone()
        return h
    _bind(h, x, group)
    block, shape, per_shard = _rs_block(x)
    own = donate or _own(block, x)
    h.meta = (shape, per_shard)
    with _issue(h, x, block):
        if not own:
            block = block.clone()
        h.buf = block
        _rs_hop(block.view(n, n, -1, LANES), 0,
                "sum" if op == "avg" else op, _permute_fn(h.impl, h.group))
    h.hops_done = 1
    return h


def wait_ring_reduce_scatter(h: SplitPhaseHandle) -> torch.Tensor:
    """Await ``start_ring_reduce_scatter``: the remaining hops, then
    [n, k, ...] with rank r's reduced slab r."""
    n = h.n
    if n == 1:
        return h.buf
    b4 = h.buf.view(n, n, -1, LANES)
    with _resume(h):
        for t in range(h.hops_done, n - 1):
            _rs_hop(b4, t, "sum" if h.op == "avg" else h.op,
                    _permute_fn(h.impl, h.group))
        ranks = _rot(n, 0, b4.device)
        mine = b4[ranks, ranks]
    h.hops_done = n - 1
    _join(h, mine)
    shape, per_shard = h.meta
    out = _from_block(mine, (n,), shape, per_shard)
    return out / n if h.op == "avg" else out


def start_ring_allgather(x: torch.Tensor, *, impl: str = "auto",
                         group=None, out: Optional[torch.Tensor] = None
                         ) -> SplitPhaseHandle:
    """Issue an allgather of x [n, ...] (the contract of
    ``ring_allgather``, ``out`` included): hop 0 now, the rest at
    ``wait_ring_allgather``."""
    n = x.shape[0]
    h = SplitPhaseHandle("allgather", n, "sum", select_impl(impl, x.device))
    if n == 1:
        h.buf = x.unsqueeze(1)
        h.meta = out
        return h
    _bind(h, x, group)
    block, shape, size = _to_block(x, 1)
    rows = block.shape[1]
    ob = _gather_out(out, x, size, rows)
    h.meta = (shape, size, out)
    with _issue(h, *(t for t in (x, block, ob) if t is not None)):
        if ob is None:
            ob = torch.empty((n, n * rows, LANES), dtype=x.dtype,
                             device=x.device)
        o4 = ob.view(n, n, rows, LANES)
        ranks = _rot(n, 0, x.device)
        o4[ranks, ranks] = block
        _ag_hop(o4, 0, _permute_fn(h.impl, h.group))
    h.buf = ob
    h.hops_done = 1
    return h


def wait_ring_allgather(h: SplitPhaseHandle) -> torch.Tensor:
    """Await ``start_ring_allgather``: the remaining hops, then [n, n, ...]
    (or the caller's ``out``)."""
    n = h.n
    if n == 1:
        out = h.meta
        return out.copy_(h.buf) if out is not None else h.buf.clone()
    o4 = h.buf.view(n, n, -1, LANES)
    with _resume(h):
        for t in range(h.hops_done, n - 1):
            _ag_hop(o4, t, _permute_fn(h.impl, h.group))
    h.hops_done = n - 1
    _join(h, h.buf)
    shape, size, out = h.meta
    if out is not None:
        return out
    return _from_block(h.buf, (n, n), shape, size)


def start_ring_permute(x: torch.Tensor, *, impl: str = "auto",
                       group=None) -> SplitPhaseHandle:
    """Issue a right rotation of x [n, ...]: rank r's shard goes to rank
    r + 1; ``wait_ring_permute`` returns ``out[r] = x[r - 1]``."""
    n = x.shape[0]
    h = SplitPhaseHandle("permute", n, "sum", select_impl(impl, x.device))
    if n == 1:
        h.buf = x
        return h
    _bind(h, x, group)
    block, shape, size = _to_block(x, 1)
    h.meta = (shape, size)
    with _issue(h, x, block):
        h.buf = _permute_fn(h.impl, h.group)(block)
    h.hops_done = 1
    return h


def wait_ring_permute(h: SplitPhaseHandle) -> torch.Tensor:
    """Await ``start_ring_permute``: the left neighbour's shard per rank."""
    if h.n == 1:
        return h.buf
    _join(h, h.buf)
    shape, size = h.meta
    return _from_block(h.buf, (h.n,), shape, size)
