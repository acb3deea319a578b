"""The ring kernels' rank form: one process per rank on one card.

``RingGroup`` (``group.py``) plays n virtual ranks in one process, one
cooperative launch for all of them. Here each rank is a process of its own
(a GPU actor on a fraction of the card) and launches only its own rank's
blocks (``ring_rank_launch`` in ``ops/csrc/ring.cu``) against a table of
peer pointers opened through CUDA IPC. ``ProcessRing`` is to ``CudaGroup``
(``collective_group/cuda_collective_group.py``) what ``_Workspace`` is to
``RingGroup``: it holds

- the symmetric workspace, one ``cudaMalloc`` per rank outside torch's
  caching allocator: the staging input and output and the comm slots and
  scales of C5 and C6, grown to the largest call (a collective
  re-exchange) and mapped once by every peer;
- the flag words, a second allocation exchanged once: per peer a ready and
  a done word, C6's receive and capacity words, and the in-kernel table of
  the rank barrier that C5's first hop and C6's phases take their scale
  at;
- the epochs, the bounded waits and the failure record.

The rule: no kernel waits on a flag that another process sets. A call of
epoch e on rank r goes, on the group's stream:

1. copy the caller's tensor into the staging input (zero padded to the
   kernels' block; C1 and C5 read the caller's memory where it lies and
   stage nothing), then write "ready e" into every peer's word for r, and
   wait until every peer has written its own into r's words;
2. the launches (C1, C2, C3, C4: one; C6: 2(n - 1) + 1 phases, each after
   the stream waited for the left neighbour's receive word and, from hop 2
   on, the right neighbour's capacity word, and followed by this rank's
   own writes of those words to its neighbours; C5, one hop of the
   split-phase int8 reduce-scatter: its send phase, then step 3, then its
   receive phase);
3. write "done e" into every peer's word and wait for every peer's; then
   copy the result out of the staging output (into the caller's ``out``
   where one is given).

``run`` is a whole call: it enqueues the call and waits for it on the
host. The split-phase hops (``start_permute``, ``start_qrs_hop``) only
enqueue: the host goes on (the ZeRO step issues the next chunk's hops and
runs this chunk's optimizer math), and ``finish`` later waits for what it
enqueued. Calls in flight are issued in the same order on every rank (the
SPMD contract) and share one staging workspace. That is safe because they
share one stream too: a call's copy-in comes after the call before it has
passed its done round on this rank's stream, and a peer writes into this
rank's staging output or comm slot only after this rank's ready word of
the next epoch, which its stream writes after its copy-out or receive.

The writes and waits are the CUDA driver's stream memory operations
(``cuStreamWriteValue64`` / ``cuStreamWaitValue64``): the GPU's front end
waits, and other processes' kernels run meanwhile in the card's default
compute mode (contexts time-slice; no MPS is needed). A stream wait has no
timeout, so the host polls each call's events against ``wait_timeout_s``
(at ``run`` or ``finish``); on expiry it names the peers that did not
reach the epoch, writes the poison word of every rank (which voids the
call and every call queued behind it: the launches still queued store
nothing into another rank's memory and send nothing, and every rank's host
raises after its done wait), then the awaited values into its own words
(which releases its stream), marks the ring failed and raises. A peer
process that has exited is named before any of this rank's work is
enqueued. A failed ring raises on every later call.
"""

from __future__ import annotations

import ctypes
import os
import socket
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.observability.xla import counts
from ray_tpu_torch.util.collective import ring
from ray_tpu_torch.util.collective.ring import (
    _DTYPE_CODES, _OPS, FLAG_SECTIONS, KINDS, LANES, MAX_BLOCKS_PER_RANK,
    MAX_RANKS,
)

# A rank's flag words (u64), in its flags allocation: ready[p] and done[p]
# written by peer p, C6's receive words (slot t % 2, written by the left
# neighbour) and capacity words (written by the right neighbour), the
# poison word (1 + the rank whose wait expired), then the in-kernel table
# (FLAG_SECTIONS x MAX_BLOCKS_PER_RANK x 2; C6's rank barrier uses its
# third section).
READY, DONE, RECV, CAP = 0, MAX_RANKS, 2 * MAX_RANKS, 2 * MAX_RANKS + 2
POISON = 2 * MAX_RANKS + 4
HOST_WORDS = 64
FLAG_BYTES = (HOST_WORDS + FLAG_SECTIONS * MAX_BLOCKS_PER_RANK * 2) * 8
# Written into this rank's own words when a wait expires: above any epoch.
RELEASED = 1 << 62
ALIGN = 256
GROW = 2 << 20          # the workspace grows in steps of this many bytes


def _lib() -> ctypes.CDLL:
    lib = ring._lib()
    if getattr(lib, "_rank_form", False):
        return lib
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    for name, res, args in (
            ("ring_rank_launch", i, [i] * 5 + [ptrs] * 4
             + [ll, ctypes.c_ulonglong, i, vp, vp, vp, vp, i, vp]),
            ("ring_stream_mem_ops", i, [ctypes.POINTER(ctypes.c_int)]),
            ("ring_stream_write", i, [vp, ptrs, i, ctypes.c_ulonglong]),
            ("ring_stream_wait", i, [vp, ptrs, i, ctypes.c_ulonglong]),
            ("ring_driver_error_string", ctypes.c_char_p, [i]),
            ("ring_ipc_alloc", i, [ll, ptrs, vp]),
            ("ring_ipc_open", i, [vp, ptrs]),
            ("ring_ipc_close", i, [vp]),
            ("ring_free", i, [vp]),
            ("ring_ipc_handle_bytes", i, []),
            ("ring_copy", i, [vp, vp, ll, vp]),
            ("ring_zero", i, [vp, ll, vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    lib._rank_form = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{ring._lib().ring_error_string(err).decode()} "
                           f"({err})")


def _check_driver(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{_lib().ring_driver_error_string(err).decode()}"
                           f" ({err})")


def _ptrs(values: Sequence[int]):
    arr = (ctypes.c_void_p * max(1, len(values)))()
    for j, v in enumerate(values):
        arr[j] = v
    return arr


def _alive(pid: int) -> bool:
    """Whether process pid runs (an exited process not yet reaped counts
    as dead)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


class _Layout:
    """Where one call's data lies: elements per chunk, the staging input
    and output sizes (elements), the copies in ((staging offset, source
    offset, count) and zero fills) and out, and the result's shape."""

    def __init__(self, kind: str, x: torch.Tensor, n: int):
        size = x.numel()
        # C1 and C5 read the caller's block where it lies (see _rank_block).
        self.in_place = kind in ("permute", "qrs_hop")
        if kind == "permute":
            self.chunk, self.in_elems, self.out_elems = size, 0, size
            self.copy_in, self.zero = [], []
            self.copy_out = [(0, 0, size)]
            self.shape = tuple(x.shape)
        elif kind == "qrs_hop":
            self.chunk, self.in_elems, self.out_elems = size // n, 0, 0
            self.copy_in, self.zero, self.copy_out = [], [], []
            self.shape = tuple(x.shape)
        elif kind in ("allreduce", "qallreduce"):
            chunk = -(-size // (n * LANES)) * LANES
            self.chunk, self.in_elems = chunk, n * chunk
            self.out_elems = self.in_elems
            self.copy_in = [(0, 0, size)]
            self.zero = [(size, self.in_elems - size)]
            self.copy_out = [(0, 0, size)]
            self.shape = tuple(x.shape)
        elif kind == "reduce_scatter":
            if x.dim() < 1 or x.shape[0] % n:
                raise ValueError(f"reduce_scatter: leading dim "
                                 f"{x.shape[0] if x.dim() else None} not "
                                 f"divisible by ring size {n}")
            per = size // n
            chunk = -(-per // LANES) * LANES
            self.chunk, self.in_elems, self.out_elems = chunk, n * chunk, chunk
            self.copy_in = [(i * chunk, i * per, per) for i in range(n)]
            self.zero = [(i * chunk + per, chunk - per) for i in range(n)]
            self.copy_out = [(0, 0, per)]
            self.shape = (x.shape[0] // n,) + tuple(x.shape[1:])
        elif kind == "allgather":
            chunk = -(-size // LANES) * LANES
            self.chunk, self.in_elems, self.out_elems = chunk, chunk, n * chunk
            self.copy_in = [(0, 0, size)]
            self.zero = [(size, chunk - size)]
            self.copy_out = [(p * size, p * chunk, size) for p in range(n)]
            self.shape = (n,) + tuple(x.shape)
        else:
            raise ValueError(f"no rank form of {kind!r}")
        es = x.element_size()
        self.in_off = 0
        # C6 runs in place in its staging buffer.
        self.out_off = 0 if kind == "qallreduce" \
            else _align(self.in_elems * es)
        end = max(self.in_off + self.in_elems * es,
                  self.out_off + self.out_elems * es)
        self.slot_off = _align(end)
        self.slot_bytes = ring._lib().ring_slot_bytes(
            KINDS.index(kind), 1, self.chunk) \
            if kind in ("qallreduce", "qrs_hop") else 0
        self.total = self.slot_off + self.slot_bytes
        self.staged_bytes = sum(c for _, _, c in self.copy_in) * es + \
            sum(c for _, _, c in self.copy_out) * es


class ProcessRing:
    """Rank ``rank`` of ``n`` on ``device``, one process per rank on one
    card. ``exchange(tag, payload, timeout=None)`` is a round among the n
    ranks (every rank calls it with the same tag, in the same order) that
    returns the n payloads in rank order: the group's coordinator. A
    round inside a call (the workspace's growth) is bounded by
    ``wait_timeout_s``, as the call's waits are. Each rank's calls
    must come in the same order with the same shapes (the SPMD contract)."""

    def __init__(self, n: int, rank: int, device: torch.device,
                 exchange: Callable[..., List[Any]],
                 wait_timeout_s: float = 5.0):
        if not 2 <= n <= MAX_RANKS:
            raise ValueError(f"the ring kernels take 2..{MAX_RANKS} ranks, "
                             f"got {n}")
        self.n, self.rank, self.device = n, rank, device
        self.left, self.right = (rank - 1) % n, (rank + 1) % n
        self.wait_timeout_s = float(wait_timeout_s)
        self._exchange = exchange
        self._epoch = 0                 # calls so far (ready / done words)
        # Rounds of the in-kernel rank barrier so far: C6's phases but the
        # last, C5's first hops (its later hops read the carry, no wait).
        self._bar_rounds = 0
        self.failed: Optional[str] = None
        self._kind: Optional[str] = None  # the kind of the call in flight
        lib = _lib()
        with torch.cuda.device(device):
            ok = ctypes.c_int(0)
            _check_driver(lib.ring_stream_mem_ops(ctypes.byref(ok)),
                          "querying 64-bit stream memory operations")
            self.stream = torch.cuda.Stream(device)
            self._side = torch.cuda.Stream(device)
            self._flags, handle = self._alloc(FLAG_BYTES)
        info = exchange("flags", {
            "handle": handle, "pid": os.getpid(),
            "host": socket.gethostname(), "stream_mem_ops": ok.value})
        lacking = [r for r, i in enumerate(info) if not i["stream_mem_ops"]]
        if lacking:
            self._free_own()
            raise RuntimeError(
                f"ranks {lacking} cannot use 64-bit stream memory "
                f"operations, the cross-process ring's transport (an "
                f"IPC-event transport is not ported)")
        if len({i["host"] for i in info}) != 1:
            self._free_own()
            raise RuntimeError("the cross-process ring runs its ranks on "
                               "one card of one host")
        self.transport = "stream memory operations"
        self._pids = [i["pid"] for i in info]
        self._peer_flags = self._open([i["handle"] for i in info],
                                      self._flags)
        self._data: Optional[int] = None
        self._data_bytes = 0
        self._peer_data: List[int] = []
        self._err_dev = torch.zeros(1, dtype=torch.int32, device=device)
        self._err_host = torch.zeros(8, dtype=torch.int64, pin_memory=True)
        dptr = ctypes.c_void_p()
        _check(ring._lib().ring_host_device_ptr(self._err_host.data_ptr(),
                                                ctypes.byref(dptr)),
               "mapping the kernel error record")
        self._err_host_dev = dptr.value
        self._words = torch.zeros(HOST_WORDS, dtype=torch.int64,
                                  pin_memory=True)
        self._poison = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        # Bytes copied in and out of the staging buffers so far.
        self.staged_bytes = 0

    def __repr__(self) -> str:
        return f"ProcessRing(rank {self.rank} of {self.n}, {self.device})"

    # ------------------------------------------------------------- memory
    def _alloc(self, nbytes: int) -> Tuple[int, bytes]:
        lib = _lib()
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.ring_ipc_handle_bytes())
        _check(lib.ring_ipc_alloc(nbytes, ctypes.byref(ptr), handle),
               f"allocating {nbytes} bytes to share")
        return ptr.value, handle.raw

    def _open(self, handles: List[bytes], own: int) -> List[int]:
        """Every rank's base address here: this rank's own, the peers'
        handles opened (a process never opens its own)."""
        lib, out = _lib(), []
        with torch.cuda.device(self.device):
            for r, h in enumerate(handles):
                if r == self.rank:
                    out.append(own)
                    continue
                ptr = ctypes.c_void_p()
                _check(lib.ring_ipc_open(h, ctypes.byref(ptr)),
                       f"opening rank {r}'s memory")
                out.append(ptr.value)
        return out

    def _close(self, bases: List[int]) -> None:
        lib = _lib()
        for r, p in enumerate(bases):
            if r != self.rank and p:
                lib.ring_ipc_close(p)

    def _free_own(self) -> None:
        lib = _lib()
        for attr in ("_data", "_flags"):
            ptr = getattr(self, attr, None)
            if ptr:
                lib.ring_free(ptr)
                setattr(self, attr, None)

    def _reserve(self, nbytes: int) -> None:
        """Grow the workspace to nbytes: every rank reaches this at the
        same call (same shapes), closes its mappings of the old buffers,
        and frees its own only after every rank has closed; then the new
        handles are exchanged and opened."""
        if nbytes <= self._data_bytes:
            return
        need = -(-nbytes // GROW) * GROW
        self.stream.synchronize()
        self._close(self._peer_data)
        self._peer_data = []
        self._round("closed", None)
        with torch.cuda.device(self.device):
            if self._data:
                _lib().ring_free(self._data)
                self._data = None
            self._data, handle = self._alloc(need)
        self._data_bytes = need
        self._peer_data = self._open(self._round("grown", handle),
                                     self._data)

    def _round(self, tag: str, payload: Any) -> List[Any]:
        """An exchange inside a call, bounded like the call's waits: a
        peer that does not arrive fails the ring."""
        try:
            return self._exchange(tag, payload, self.wait_timeout_s)
        except Exception as e:
            self.failed = (f"{self}: growing the workspace: {e}; the group "
                           f"cannot be used again")
            raise RuntimeError(self.failed) from None

    def destroy(self) -> None:
        try:
            if self.failed is None:
                self.stream.synchronize()
        finally:
            self._close(self._peer_data)
            self._close(self._peer_flags)
            self._peer_data, self._peer_flags = [], []
            self._free_own()

    # -------------------------------------------------------------- flags
    def _own_word(self, index: int) -> int:
        return self._flags + index * 8

    def _peer_word(self, peer: int, index: int) -> int:
        return self._peer_flags[peer] + index * 8

    def _write(self, stream, addrs: List[int], value: int) -> None:
        _check_driver(_lib().ring_stream_write(
            stream.cuda_stream, _ptrs(addrs), len(addrs), value),
            "a stream write of a flag")

    def _wait(self, addrs: List[int], value: int) -> None:
        _check_driver(_lib().ring_stream_wait(
            self.stream.cuda_stream, _ptrs(addrs), len(addrs), value),
            "a stream wait on a flag")

    def _peers(self) -> List[int]:
        return [p for p in range(self.n) if p != self.rank]

    # ------------------------------------------------------------- health
    def raise_if_failed(self) -> None:
        if self.failed is not None:
            raise RuntimeError(self.failed)
        dead = [p for p in self._peers() if not _alive(self._pids[p])]
        if dead:
            self.failed = (f"{self}: peer rank(s) {dead} (pid "
                           f"{[self._pids[p] for p in dead]}) exited; the "
                           f"group cannot be used again")
            raise RuntimeError(self.failed)

    def _await(self, event, stage: str, want: int) -> None:
        """Poll event until the stream passes it, or expire at the
        deadline (see _expire)."""
        start = time.monotonic()
        deadline = start + self.wait_timeout_s
        while not event.query():
            now = time.monotonic()
            if now > deadline:
                self._expire(stage, want)
            time.sleep(0 if now - start < 0.002 else 0.0001)

    def _expire(self, stage: str, want: int) -> None:
        """A wait outlived the deadline: name who is missing, release this
        rank's stream by writing the awaited values into its own words,
        mark the ring failed and raise."""
        _check(_lib().ring_copy(self._words.data_ptr(), self._flags,
                                HOST_WORDS * 8, self._side.cuda_stream),
               "reading the flag words")
        self._side.synchronize()
        w = self._words.tolist()
        at = READY if stage == "ready" else DONE
        late = [(p, w[at + p]) for p in self._peers() if w[at + p] < want]
        # Inside C6 the stream may wait on a neighbour's hop words instead.
        hops = (f"; C6's receive words from rank {self.left} "
                f"{w[RECV:RECV + 2]}, capacity words from rank {self.right} "
                f"{w[CAP:CAP + 2]}" if self._kind == "qallreduce"
                and stage == "done" else "")
        dead = [p for p in self._peers() if not _alive(self._pids[p])]
        # Void the call on every rank before this stream runs on: what it
        # still has queued would run on whatever the slots hold and write
        # its done words, which a peer that was only slow must not take
        # for a result.
        self._write(self._side, [self._own_word(POISON)] + [
            self._peer_word(p, POISON) for p in self._peers()
            if p not in dead], self.rank + 1)
        self._side.synchronize()
        self._write(self._side, [self._own_word(i) for i in range(HOST_WORDS)
                                 if i != POISON], RELEASED)
        self._side.synchronize()
        self.failed = (
            f"{self}: timed out after {self.wait_timeout_s} s waiting for "
            f"the peers' {stage} words to reach epoch {want}: "
            + ", ".join(f"peer rank {p} at {seen}" for p, seen in late)
            + hops + (f"; peer rank(s) {dead} exited" if dead else "")
            + "; the group cannot be used again")
        raise RuntimeError(self.failed)

    def _voided(self, epoch: int) -> None:
        by = int(self._poison[0])
        if by == 0:
            return
        self.failed = (f"{self}: rank {by - 1}'s wait expired during the "
                       f"call of epoch {epoch}, so its result is void; the "
                       f"group cannot be used again")
        raise RuntimeError(self.failed)

    def _kernel_failed(self) -> None:
        if int(self._err_host[0]) == 0:
            return
        _, kind, rank, block, hop, what, want, seen = (
            int(v) for v in self._err_host.tolist())
        self.failed = (f"ring {KINDS[kind]} kernel stopped on {self}: rank "
                       f"{rank}, block {block}, hop {hop} waited for its "
                       f"rank barrier to reach {want} (saw {seen}); the "
                       f"group cannot be used again")
        raise RuntimeError(self.failed)

    # --------------------------------------------------------------- calls
    def run(self, kind: str, op: str, x: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One call of ``kind`` (reduce_scatter, allgather, allreduce or
        qallreduce) on this rank's tensor x: returns this rank's result
        (written into ``out`` if given: contiguous, its shape and x's
        dtype on the ring's device)."""
        call = self._enqueue(kind, op, x, out)
        self.finish([call])
        return call.result

    def start_permute(self, x: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> "_Call":
        """Enqueue one C1 hop of this rank's block x [rows, 128]: ``out``
        (or a new tensor) gets the left neighbour's block. Returns the
        call for ``finish``; ``call.result`` is ``out``, complete on the
        ring's stream."""
        return self._enqueue("permute", "sum", x, out)

    def start_qrs_hop(self, buf: torch.Tensor, t: int,
                      carry: torch.Tensor) -> "_Call":
        """Enqueue hop t of the split-phase int8 reduce-scatter on this
        rank's f32 buffer [n * c, 128], in place: chunk r - t - 1 goes to
        the right neighbour, and what the left one sends is added onto
        chunk r - t - 2. ``carry`` is the reduce-scatter's own [n - 1, n]
        int64 table on the ring's device (column r is this rank's), which
        hop 0 zeroes on the stream. Returns the call for ``finish``."""
        return self._enqueue("qrs_hop", "sum", buf, buf, hop=t, carry=carry)

    def _enqueue(self, kind: str, op: str, x: torch.Tensor,
                 out: Optional[torch.Tensor], hop: int = 0,
                 carry: Optional[torch.Tensor] = None) -> "_Call":
        """Enqueue one call on the ring's stream (after the current
        stream's work so far) without waiting on the host."""
        self.raise_if_failed()
        lay = _Layout(kind, x, self.n)
        if lay.in_place:
            x = _rank_block(kind, x)
        else:
            x = x.contiguous()
        self._kind = kind
        self._reserve(lay.total)
        lib, es = _lib(), x.element_size()
        e = self._epoch = self._epoch + 1
        st = self.stream
        st.wait_stream(torch.cuda.current_stream(self.device))
        x.record_stream(st)
        if out is None:
            with torch.cuda.stream(st):
                out = torch.empty(lay.shape, dtype=x.dtype,
                                  device=self.device)
        elif (tuple(out.shape) != lay.shape or out.dtype != x.dtype
              or out.device != self.device or not out.is_contiguous()):
            raise ValueError(f"ring {kind}: out must be a contiguous "
                             f"{lay.shape} {x.dtype} tensor on "
                             f"{self.device}")
        else:
            out.record_stream(st)
        if carry is not None:
            carry.record_stream(st)
        sp = st.cuda_stream
        base = self._data
        for d, s, c in lay.copy_in:
            _check(lib.ring_copy(base + lay.in_off + d * es,
                                 x.data_ptr() + s * es, c * es, sp),
                   "staging the input")
        for d, c in lay.zero:
            if c:
                _check(lib.ring_zero(base + lay.in_off + d * es, c * es, sp),
                       "padding the input")
        peers = self._peers()
        self._write(st, [self._peer_word(p, READY + self.rank)
                         for p in peers], e)
        self._wait([self._own_word(READY + p) for p in peers], e)
        ready = torch.cuda.Event()
        ready.record(st)
        if kind == "qrs_hop":
            if hop == 0:
                with torch.cuda.stream(st):
                    carry.zero_()
            self._launch(kind, op, x.dtype, lay, hop=hop, phase=0,
                         src=x, carry=carry)
        elif kind == "permute":
            self._launch(kind, op, x.dtype, lay, src=x)
        else:
            self._launches(kind, op, x.dtype, lay)
        self._write(st, [self._peer_word(p, DONE + self.rank)
                         for p in peers], e)
        self._wait([self._own_word(DONE + p) for p in peers], e)
        if kind == "qrs_hop":
            # Every peer's send phase has stored: the left neighbour's
            # payload is in this rank's slot.
            self._launch(kind, op, x.dtype, lay, hop=hop, phase=1,
                         src=x, carry=carry)
        # Read after every peer's done word: a rank that voids the call
        # writes the poison before its stream can write done. The word
        # only ever goes from 0 to set, so one pinned copy serves every
        # call in flight.
        _check(lib.ring_copy(self._poison.data_ptr(), self._own_word(POISON),
                             8, sp), "reading the poison word")
        for d, s, c in lay.copy_out:
            _check(lib.ring_copy(out.data_ptr() + d * es,
                                 base + lay.out_off + s * es, c * es, sp),
                   "copying the result out")
        done = torch.cuda.Event()
        done.record(st)
        self.staged_bytes += lay.staged_bytes
        return _Call(kind, e, ready, done, out)

    def finish(self, calls: Sequence["_Call"]) -> None:
        """Wait on the host, in order, for calls this ring enqueued
        (bounded: see the module docstring); raise if one was voided or a
        kernel stopped."""
        for c in calls:
            self._kind = c.kind
            self._await(c.ready, "ready", c.epoch)
            self._await(c.done, "done", c.epoch)
            self._kernel_failed()
            self._voided(c.epoch)

    def _launch(self, kind: str, op: str, dtype: torch.dtype,
                lay: _Layout, base: int = 0, hop: int = 0, phase: int = 0,
                src: Optional[torch.Tensor] = None,
                carry: Optional[torch.Tensor] = None) -> None:
        offs = lambda off: [b + off for b in self._peer_data]  # noqa: E731
        slots = offs(lay.slot_off) if lay.slot_bytes else []
        tables = [f + HOST_WORDS * 8 for f in self._peer_flags] \
            if kind in ("qallreduce", "qrs_hop") else []
        if src is None:
            ins, outs = offs(lay.in_off), offs(lay.out_off)
        else:
            # C1 and C5 read (C5 also writes) the caller's memory: only
            # this rank's entry is used.
            ins = [src.data_ptr() if p == self.rank else 0
                   for p in range(self.n)]
            outs = ins if kind == "qrs_hop" else offs(lay.out_off)
        if kind == "qrs_hop" and phase == 0 and hop == 0:
            base = self._bar_rounds
            self._bar_rounds += 1
        err = _lib().ring_rank_launch(
            KINDS.index(kind), _OPS[op], _DTYPE_CODES[dtype], self.n,
            self.rank, _ptrs(ins), _ptrs(outs),
            _ptrs(slots) if slots else None,
            _ptrs(tables) if tables else None, lay.chunk, base, hop,
            self._own_word(POISON), self._err_dev.data_ptr(),
            self._err_host_dev,
            self.stream.cuda_stream, phase,
            None if carry is None else carry.data_ptr())
        _check(err, f"ring {kind} rank launch")
        _RANK_KERNELS[kind].launches += 1

    def _launches(self, kind: str, op: str, dtype: torch.dtype,
                  lay: _Layout) -> None:
        if kind != "qallreduce":
            self._launch(kind, op, dtype, lay)
            return
        # C6: phase t combines hop t - 1 and sends hop t, after the left
        # neighbour's payload of hop t - 1 is in this rank's slot and the
        # right neighbour has drained its slot t % 2 (hop t - 2). Its
        # epochs are the rank barrier's rounds, which every rank counts
        # alike (C5's first hops take rounds too).
        total = 2 * (self.n - 1)
        base = self._bar_rounds
        self._bar_rounds += total
        for t in range(total + 1):
            waits = []
            if t >= 1:
                waits.append((RECV + (t - 1) % 2, base + t))
            if 2 <= t < total:
                waits.append((CAP + t % 2, base + t - 1))
            for word, value in waits:
                self._wait([self._own_word(word)], value)
            self._launch(kind, "sum", dtype, lay, base=base, hop=t)
            if t >= 1 and t - 1 < total - 2:
                self._write(self.stream,
                            [self._peer_word(self.left, CAP + (t - 1) % 2)],
                            base + t)
            if t < total:
                self._write(self.stream,
                            [self._peer_word(self.right, RECV + t % 2)],
                            base + t + 1)


class _Call:
    """One call enqueued on a ring: its kind, epoch, the events after its
    ready and done rounds, and its result (complete on the ring's stream
    once ``done`` has passed)."""

    __slots__ = ("kind", "epoch", "ready", "done", "result")

    def __init__(self, kind, epoch, ready, done, result):
        self.kind, self.epoch = kind, epoch
        self.ready, self.done, self.result = ready, done, result


def _rank_block(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The caller's block as C1 and C5 read it where it lies: [rows, 128]
    (C5: f32, rows a multiple of n), contiguous and 16-byte aligned."""
    if x.dim() != 2 or x.shape[1] != LANES or x.shape[0] < 1:
        raise ValueError(f"ring {kind} rank form takes [rows, {LANES}], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"ring {kind} rank form: the block must be "
                         f"contiguous and 16-byte aligned")
    return x


# ---------------------------------------------------------------------------
# The rank form's wrappers, one per kernel, each counting its launches.
# ---------------------------------------------------------------------------

def _rank_cost(factor):
    """The rank form's count in a program's costs: its own block's share
    of the kernel's bytes, ``factor(n)`` times x's bytes."""
    def cost_of(x, *a, ring: ProcessRing, **kw):
        return 0.0, factor(ring.n) * x.numel() * x.element_size()
    return cost_of


def _check_rank(name: str, x: torch.Tensor, ring_: ProcessRing) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.device != ring_.device:
        raise ValueError(f"{name}: tensor on {x.device}, ring on "
                         f"{ring_.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype} (float32, "
                        f"bfloat16, float16 and int32 only)")


@counts(_rank_cost(lambda n: 2))
def ring_allreduce_rank_cuda(x: torch.Tensor, op: str = "sum", *,
                             ring: ProcessRing,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """C4, this rank's launch: returns the reduction of every rank's x (op
    sum, max, min or prod), this rank's row of ``ring_allreduce`` on the
    ranks' stacked tensors (into ``out`` if given; ``out`` may be x).
    ``.launches`` counts launches."""
    _check_rank("ring_allreduce_rank_cuda", x, ring)
    return ring.run("allreduce", op, x, out)


@counts(_rank_cost(lambda n: 1 + 1 / n))
def ring_reduce_scatter_rank_cuda(x: torch.Tensor, op: str = "sum", *,
                                  ring: ProcessRing,
                                  out: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """C2, this rank's launch on x [n * k, ...]: returns [k, ...], this
    rank's row of ``ring_reduce_scatter`` on the stacked tensors (into
    ``out`` if given). ``.launches`` counts launches."""
    _check_rank("ring_reduce_scatter_rank_cuda", x, ring)
    return ring.run("reduce_scatter", op, x, out)


@counts(_rank_cost(lambda n: 1 + n))
def ring_allgather_rank_cuda(x: torch.Tensor, *, ring: ProcessRing,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """C3, this rank's launch: returns [n, *x.shape], every rank's x in
    rank order (into ``out`` if given: the caller's flat params take it
    with no [n, ...] temporary). ``.launches`` counts launches."""
    _check_rank("ring_allgather_rank_cuda", x, ring)
    return ring.run("allgather", "sum", x, out)


@counts(_rank_cost(lambda n: 2))
def ring_qallreduce_rank_cuda(x: torch.Tensor, *, ring: ProcessRing,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """C6, this rank's 2(n - 1) + 1 phase launches on f32 x: returns this
    rank's row of ``ring_qallreduce_plain`` on the stacked blocks (the
    int8 ring's sum; into ``out`` if given, which may be x).
    ``.launches`` counts launches."""
    _check_rank("ring_qallreduce_rank_cuda", x, ring)
    if x.dtype != torch.float32:
        raise TypeError(f"ring_qallreduce_rank_cuda: unsupported dtype "
                        f"{x.dtype} (the int8 ring takes float32 only)")
    return ring.run("qallreduce", "sum", x, out)


@counts(_rank_cost(lambda n: 2))
def ring_permute_rank_cuda(x: torch.Tensor, *, ring: ProcessRing,
                           out: Optional[torch.Tensor] = None) -> "_Call":
    """C1, this rank's launch on its block x [rows, 128], enqueued: the
    call's ``result`` (``out`` if given) gets the left neighbour's block,
    this rank's row of ``ring_permute_plain`` on the stacked blocks, once
    ``ring.finish`` has waited for it. ``.launches`` counts launches."""
    _check_rank("ring_permute_rank_cuda", x, ring)
    return ring.start_permute(x, out)


@counts(_rank_cost(lambda n: 3 / n))
def ring_qrs_hop_rank_cuda(buf: torch.Tensor, t: int, carry: torch.Tensor,
                           *, ring: ProcessRing) -> "_Call":
    """C5 in place, this rank's two launches (send, receive) of hop t of
    the split-phase int8 reduce-scatter on its f32 buffer [n * c, 128],
    enqueued: once ``ring.finish`` has waited for the call, buf is this
    rank's row of ``ring_qrs_hop_plain`` on the stacked buffers, and
    column r of the carry table [n - 1, n] int64 is what
    ``ring_qrs_hop_cuda`` would fill there. ``.launches`` counts
    launches."""
    _check_rank("ring_qrs_hop_rank_cuda", buf, ring)
    n = ring.n
    if buf.dtype != torch.float32:
        raise TypeError(f"ring_qrs_hop_rank_cuda: unsupported dtype "
                        f"{buf.dtype} (the int8 ring takes float32 only)")
    if buf.dim() != 2 or buf.shape[1] != LANES or buf.shape[0] % n:
        raise ValueError(f"ring_qrs_hop_rank_cuda takes [n * c, {LANES}] "
                         f"with n = {n}, got {tuple(buf.shape)}")
    if not 0 <= t < n - 1:
        raise ValueError(f"ring_qrs_hop_rank_cuda: hop {t} of a "
                         f"reduce-scatter of {n - 1} hops")
    if carry is None or carry.shape != (n - 1, n) \
            or carry.dtype != torch.int64 or carry.device != buf.device \
            or not carry.is_contiguous():
        raise ValueError(f"ring_qrs_hop_rank_cuda needs the reduce-scatter's "
                         f"carry table, a contiguous [{n - 1}, {n}] int64 "
                         f"tensor on {buf.device}")
    return ring.start_qrs_hop(buf, t, carry)


for _fn in (ring_allreduce_rank_cuda, ring_reduce_scatter_rank_cuda,
            ring_allgather_rank_cuda, ring_qallreduce_rank_cuda,
            ring_permute_rank_cuda, ring_qrs_hop_rank_cuda):
    _fn.launches = 0

_RANK_KERNELS = {"allreduce": ring_allreduce_rank_cuda,
                 "reduce_scatter": ring_reduce_scatter_rank_cuda,
                 "allgather": ring_allgather_rank_cuda,
                 "qallreduce": ring_qallreduce_rank_cuda,
                 "permute": ring_permute_rank_cuda,
                 "qrs_hop": ring_qrs_hop_rank_cuda}
KERNELS = tuple(_RANK_KERNELS.values())
