"""``RingGroup``: a ring of n virtual ranks on one device.

The port's form of a one-axis mesh (``ray_tpu/parallel/mesh.py``
``mesh_axis_size``) and of the device half of the reference's
``PallasGroup`` (``collective_group/pallas_collective_group.py:70-140``):
``allreduce`` (exact, or int8 with ``quantized=True``), ``allgather`` and
``reducescatter`` on rank-major tensors (rank r's data is ``x[r]``),
through the ring kernels C2-C4 and C6 on a CUDA device and their plain
versions on the CPU. Unlike ``PallasGroup`` there
is no fallback: on the card the group launches the kernel or raises.

The group owns the kernels' workspace: the comm slots of the int8 ring
(C5, C6: int8 payloads and per-block scales, grown to the largest call and
reused; C1-C4 need none), one flag table per kernel kind (receive,
capacity and, for C5 and C6, the per-rank barrier words), a per-kind call
counter that sets each call's flag epochs, a comm stream for the
split-phase forms, and the timeout record (pinned host memory the kernels
write when a spin times out). Its ring launches are ordered: a launch on
another stream than the previous one first waits for that one, so two
calls never share slots or flags at once.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.util.collective import ring
from ray_tpu_torch.util.collective.quantized import quantized_ring_allreduce
from ray_tpu_torch.util.collective.ring import (
    FLAG_SECTIONS, KINDS, MAX_BLOCKS_PER_RANK, MAX_RANKS, hops,
)

# What a stopped kernel waited for, by ring.cu's Wait code (the last: a
# carried max of C5's in-place form that its hop before did not leave).
_WAITS = ("timed out waiting for the receive flag to reach epoch",
          "timed out waiting for the capacity flag to reach epoch",
          "timed out waiting for the barrier flag to reach epoch",
          "timed out waiting for the count of this call's peer arrivals "
          "to reach",
          "found no max carried from the hop before, tagged")


class _Workspace(NamedTuple):
    base: int
    stream: Any
    slots_ptr: Optional[int]
    flags_ptr: int
    err_dev_ptr: int
    err_host_ptr: int


class RingGroup:
    """n virtual ranks on ``device`` (default: the card; raises without
    one, as every entry point of the port does; pass ``device="cpu"`` for
    the plain versions)."""

    def __init__(self, n: int, device: Optional[Union[str, torch.device]]
                 = None):
        if n < 1:
            raise ValueError(f"ring size must be >= 1, got {n}")
        self.n = int(n)
        self.device = resolve_device(device)
        self.comm_stream = None
        self._seq: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self._flags: Dict[str, torch.Tensor] = {}
        self._slots: Optional[torch.Tensor] = None
        self._last: Optional[Any] = None      # stream of the last launch
        self._err_host = None
        self._err_host_ptr: Optional[int] = None
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            if self.n > MAX_RANKS:
                raise ValueError(f"the ring kernels take at most "
                                 f"{MAX_RANKS} ranks, got {self.n}")
            self.comm_stream = torch.cuda.Stream(self.device)
            self._err_dev = torch.zeros(1, dtype=torch.int32,
                                        device=self.device)
            self._err_host = torch.zeros(8, dtype=torch.int64,
                                         pin_memory=True)

    def __repr__(self) -> str:
        return f"RingGroup(n={self.n}, device={self.device})"

    # ------------------------------------------------------------ data plane
    def allreduce(self, x: torch.Tensor, op: Any = "sum",
                  quantized: bool = False) -> torch.Tensor:
        """``ring_allreduce`` over this group (C4 on the card), or with
        ``quantized`` ``quantized_ring_allreduce`` (C6, or its bf16 rung),
        as the reference's ``PallasGroup.device_allreduce``."""
        if quantized:
            return quantized_ring_allreduce(x, op, group=self)
        return ring.ring_allreduce(x, op, group=self)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """``ring_allgather`` over this group (C3 on the card)."""
        return ring.ring_allgather(x, group=self)

    def reducescatter(self, x: torch.Tensor, op: Any = "sum"
                      ) -> torch.Tensor:
        """``ring_reduce_scatter`` over this group (C2 on the card)."""
        return ring.ring_reduce_scatter(x, op, group=self)

    # --------------------------------------------------------------- health
    def raise_if_failed(self) -> None:
        """Raise if a ring kernel of this group has stopped on a timeout or
        a missing carry (reads the pinned record; does not wait for the
        device)."""
        if self._err_host is None or int(self._err_host[0]) == 0:
            return
        _, kind, rank, block, hop, what, want, seen = (
            int(v) for v in self._err_host.tolist())
        raise RuntimeError(
            f"ring {KINDS[kind]} kernel stopped on {self}: rank {rank}, "
            f"block {block}, hop {hop} {_WAITS[what]} {want} (saw {seen}); "
            f"the group cannot be used again")

    def check(self) -> None:
        """Wait for the device, then raise if a ring kernel stopped."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.raise_if_failed()

    # ------------------------------------------------------------ workspace
    def _begin(self, kind: str, slot_bytes: int) -> _Workspace:
        """Workspace for one launch of ``kind`` on the current stream."""
        self.raise_if_failed()
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._last is not None and self._last != stream:
                stream.wait_stream(self._last)
            flags = self._flags.get(kind)
            if flags is None:
                flags = torch.zeros((self.n, FLAG_SECTIONS,
                                     MAX_BLOCKS_PER_RANK, 2),
                                    dtype=torch.int64, device=self.device)
                self._flags[kind] = flags
            flags.record_stream(stream)
            slots_ptr = None
            if slot_bytes:
                if self._slots is None or self._slots.numel() < slot_bytes:
                    self._slots = None
                    self._slots = torch.empty(slot_bytes, dtype=torch.uint8,
                                              device=self.device)
                self._slots.record_stream(stream)
                slots_ptr = self._slots.data_ptr()
            if self._err_host_ptr is None:
                dptr = ctypes.c_void_p()
                err = ring._lib().ring_host_device_ptr(
                    self._err_host.data_ptr(), ctypes.byref(dptr))
                if err != 0:
                    raise RuntimeError(f"pinned timeout record not mapped "
                                       f"({err})")
                self._err_host_ptr = dptr.value
            base = self._seq[kind] * hops(kind, self.n)
            self._seq[kind] += 1
            return _Workspace(base, stream, slots_ptr, flags.data_ptr(),
                              self._err_dev.data_ptr(), self._err_host_ptr)

    def _end(self, ws: _Workspace) -> None:
        self._last = ws.stream


_default: Dict[Tuple[int, str], RingGroup] = {}
_default_lock = threading.Lock()


def default_group(n: int, device: torch.device) -> RingGroup:
    """The group ring functions use on ``device`` when none is given."""
    key = (n, str(device))
    with _default_lock:
        group = _default.get(key)
        if group is None:
            group = _default[key] = RingGroup(n, device)
        return group
