"""The ``cuda`` collective backend: the port's ring kernels with one process
per rank, the counterpart of the reference's ``PallasGroup``
(``ray_tpu/util/collective/collective_group/pallas_collective_group.py``).

``CudaGroup`` subclasses ``TorchGroup`` as ``PallasGroup`` subclasses
``XLAGroup``: the control plane (the coordinator, the gloo group, the
barrier, send / recv) is the parent's, and the group also exchanges the
ring's workspace handles through the coordinator. The data plane:

- ``device_allreduce(x, op, quantized=)`` and ``ring_collective(kind, x,
  op, out=)`` for the four kinds of the reference's ``_ring_fn``:
  ``allreduce`` (C4), ``quantized_allreduce`` (C6, with the int8 ring's
  fallback ladder), ``allgather`` (C3) and ``reducescatter`` (C2). Each
  takes this rank's tensor and returns this rank's row of the rank-major
  function (``ring_allreduce`` etc.) on the ranks' stacked tensors, into
  the caller's ``out`` where one is given (the ZeRO step's flat params
  take C3's result so, with no [n, ...] temporary). On the card each
  rank launches its own part (``process_ring.py``); on the CPU
  (``device="cpu"``) the plain ring functions run over the stack gathered
  through gloo, so the CPU path has the ring's bits.
- The split-phase hops the ZeRO step's overlap routes run (``ring.py``'s
  and ``quantized.py``'s ``start_*`` / ``wait_*`` with this group):
  ``start_hop("permute", x, out=)`` (C1: the left neighbour's block) and
  ``start_hop("qrs_hop", buf, t=, carry=)`` (C5 in place: hop t of the
  split-phase int8 reduce-scatter) enqueue on ``comm_stream`` and return
  at once; ``finish_hops`` waits for them. On the CPU each hop runs its
  plain version on the gathered stack when it is started.
- ``gather(x)``: every rank's x stacked rank-major on the group's device
  (through gloo), for the ZeRO step's per-rank scalars.
- Host-level ops keep the reference's dispatch: ``allreduce`` (any op of
  ``_RING_OPS``) rides C4, or C6 in a group made with ``quantized=True``;
  ``reducescatter`` is the reference's "allreduce, then split axis 0,
  take this rank's piece" (so C4's bits, not C2's, whose fold starts one
  rank later); ``reduce`` is the allreduce on ``dst`` and the input
  elsewhere; ``allgather`` and ``broadcast`` ride C3 (copies are exact).
  Results are tensors on the group's device.

There is no fallback: the reference catches any exception of its device
path and falls back to the host arithmetic; on the card this group
launches the kernels or raises, as ``RingGroup`` does. Entry points run on
the card unless ``device="cpu"`` is given; without a card that default
raises.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.util.collective import quantized as Q
from ray_tpu_torch.util.collective import ring as R
from ray_tpu_torch.util.collective.collective_group.torch_collective_group \
    import TorchGroup, _host_tensor
from ray_tpu_torch.util.collective.process_ring import (
    ProcessRing, ring_allgather_rank_cuda, ring_allreduce_rank_cuda,
    ring_permute_rank_cuda, ring_qallreduce_rank_cuda,
    ring_qrs_hop_rank_cuda, ring_reduce_scatter_rank_cuda,
)
from ray_tpu_torch.util.collective.types import ReduceOp

_RING_OPS = {
    ReduceOp.SUM: "sum",
    ReduceOp.AVERAGE: "avg",
    ReduceOp.MIN: "min",
    ReduceOp.MAX: "max",
    ReduceOp.PRODUCT: "prod",
}
KINDS = ("allreduce", "quantized_allreduce", "allgather", "reducescatter")


class _Done:
    """A hop of the CPU path: computed when it was started."""

    __slots__ = ("result",)

    def __init__(self, result):
        self.result = result


class CudaGroup(TorchGroup):
    """Collective group whose device-side ops are the port's ring kernels,
    one process per rank."""

    backend_name = "cuda"
    # ring.py and quantized.py take this group's rank tensors, one rank's
    # block, where a RingGroup takes the ranks' [n, ...] stack.
    rank_form = True

    def __init__(self, world_size: int, rank: int, group_name: str,
                 device: Optional[Union[str, torch.device]] = None,
                 quantized: bool = False, timeout_s: float = 300.0,
                 wait_timeout_s: float = 5.0):
        # The device first: without a card the default raises before any
        # rendezvous.
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        super().__init__(world_size, rank, group_name, timeout_s=timeout_s)
        self._quantized = quantized
        self._exchanges = 0
        self.ring: Optional[ProcessRing] = None
        if self.device.type == "cuda" and world_size > 1:
            self.ring = ProcessRing(world_size, rank, self.device,
                                    self._exchange, wait_timeout_s)
            print(f"[collective] group {group_name!r} rank {rank} of "
                  f"{world_size}: ring kernels across processes on "
                  f"{self.device}, ordered by {self.ring.transport}",
                  flush=True)

    def _exchange(self, tag: str, payload: Any,
                  timeout: Optional[float] = None) -> List[Any]:
        """A round of the group through the coordinator: every rank's
        payload, in rank order (bounded by ``timeout``, default the
        group's)."""
        self._exchanges += 1
        uid = f"{self._gen}:cuda:{tag}:{self._exchanges}"
        timeout = self._timeout if timeout is None else timeout
        data = ray_tpu_torch.get(self._hub.gather_round.remote(
            uid, self.rank, payload, timeout), timeout=timeout + 10)
        return [data[r] for r in range(self.world_size)]

    # ------------------------------------------------------------- data plane
    def _tensor(self, tensor) -> torch.Tensor:
        if not isinstance(tensor, torch.Tensor):
            tensor = _host_tensor(tensor)
        return tensor.to(self.device)

    @property
    def n(self) -> int:
        return self.world_size

    @property
    def comm_stream(self):
        """The stream the ring's calls run on (None on the CPU)."""
        return None if self.ring is None else self.ring.stream

    def gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's tensor, stacked rank-major on the group's device
        (a host-level round through gloo: the values are exact)."""
        return self._stack(tensor.detach().cpu()).to(self.device)

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """The rank-major stack the plain functions run on: every rank's
        tensor through gloo on the CPU, x alone in a group of one."""
        if self.world_size == 1:
            return x[None]
        return self._gather_tensors(x)

    def ring_collective(self, kind: str, tensor,
                        op: ReduceOp = ReduceOp.SUM,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One of the reference's ``_ring_fn`` kinds on this rank's tensor;
        returns this rank's result (allgather: [n, *shape]), written into
        ``out`` if given (its shape and dtype)."""
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        x = self._tensor(tensor)
        name = R._norm_op(op)
        if self.ring is None:       # the CPU, or a group of one
            stack = self._stack(x)
            fn = {"allreduce": lambda s: R.ring_allreduce(s, name),
                  "quantized_allreduce":
                      lambda s: Q.quantized_ring_allreduce(s, name),
                  "allgather": R.ring_allgather,
                  "reducescatter":
                      lambda s: R.ring_reduce_scatter(s, name)}[kind]
            res = fn(stack)[self.rank]
            return res if out is None else out.copy_(res)
        if kind == "allgather":
            return ring_allgather_rank_cuda(x, ring=self.ring, out=out)
        if kind == "quantized_allreduce":
            name = Q._check_args(x, name, "allreduce", "ring_allreduce")
            if Q._wants_bf16(x[None]):
                res = self.ring_collective(
                    "allreduce", x.to(torch.bfloat16), op).to(x.dtype)
                return res if out is None else out.copy_(res)
            if x.dtype == torch.float32:
                res = ring_qallreduce_rank_cuda(x, ring=self.ring, out=out)
            else:
                res = ring_qallreduce_rank_cuda(
                    x.to(torch.float32), ring=self.ring).to(x.dtype)
                res = res if out is None else out.copy_(res)
        elif kind == "allreduce":
            res = ring_allreduce_rank_cuda(
                x, "sum" if name == "avg" else name, ring=self.ring, out=out)
        else:
            res = ring_reduce_scatter_rank_cuda(
                x, "sum" if name == "avg" else name, ring=self.ring, out=out)
        if name != "avg":
            return res
        return res / self.world_size if out is None \
            else torch.div(res, self.world_size, out=res)

    # ------------------------------------------------- split-phase hops
    def start_hop(self, kind: str, x: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None, t: int = 0,
                  carry: Optional[torch.Tensor] = None):
        """One hop on this rank's block, enqueued: ``"permute"`` (C1, x
        [rows, 128]: the left neighbour's block into ``out`` or a new
        tensor) or ``"qrs_hop"`` (C5 in place on the f32 buffer x
        [n * c, 128], hop t, with the reduce-scatter's [n - 1, n] int64
        ``carry`` table). Returns a hop whose ``result`` is the output
        (complete on ``comm_stream``); ``finish_hops`` waits for it. On
        the CPU the plain version runs on the gathered stack now."""
        if kind not in ("permute", "qrs_hop"):
            raise ValueError(f"hop kind must be 'permute' or 'qrs_hop', "
                             f"got {kind!r}")
        if self.ring is not None:
            if kind == "permute":
                return ring_permute_rank_cuda(x, ring=self.ring, out=out)
            return ring_qrs_hop_rank_cuda(x, t, carry, ring=self.ring)
        stack = self._stack(x)
        if kind == "permute":
            res = R.ring_permute_plain(stack)[self.rank]
            return _Done(res if out is None else out.copy_(res))
        n = self.world_size
        table = torch.zeros((n - 1, n), dtype=torch.int64)
        Q.ring_qrs_hop_plain(stack, t, table)
        x.copy_(stack[self.rank])
        if carry is not None:
            if t == 0:
                carry.zero_()
            if t + 2 < n:
                carry[t + 1, self.rank] = table[t + 1, self.rank]
        return _Done(x)

    def finish_hops(self, hops) -> None:
        """Wait on the host for hops ``start_hop`` enqueued (bounded by
        the ring's wait deadline); raises what the ring raises."""
        if self.ring is not None:
            self.ring.finish(hops)

    def device_allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM,
                         quantized: Optional[bool] = None) -> torch.Tensor:
        """Allreduce this rank's tensor through the ring kernels (C4, or C6
        with ``quantized``; default: the group's)."""
        if quantized is None:
            quantized = self._quantized
        kind = "quantized_allreduce" if quantized else "allreduce"
        return self.ring_collective(kind, tensor, op)

    # ---------------------------------------------------- host-level parity
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        if op not in _RING_OPS:
            raise ValueError(f"unsupported op {op}")
        return self.device_allreduce(tensor, op)

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        out = self.allreduce(tensor, op)
        return out if self.rank == dst_rank else tensor

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        full = self.allreduce(tensor, op)
        return torch.tensor_split(full, self.world_size, dim=0)[self.rank]

    def allgather(self, tensor) -> List[torch.Tensor]:
        out = self.ring_collective("allgather", tensor)
        return [out[r] for r in range(self.world_size)]

    def broadcast(self, tensor, src_rank: int = 0):
        return self.ring_collective("allgather", tensor)[src_rank]

    def _send_payload(self, tensor):
        if isinstance(tensor, torch.Tensor):
            return tensor.detach().cpu()
        return np.asarray(tensor)

    def recv(self, src_rank: int):
        return self._tensor(super().recv(src_rank))

    def destroy(self):
        if self.ring is not None:
            self.ring.destroy()
            self.ring = None
        super().destroy()
