"""The ``cuda`` collective backend: the port's ring kernels with one process
per rank, the counterpart of the reference's ``PallasGroup``
(``ray_tpu/util/collective/collective_group/pallas_collective_group.py``).

``CudaGroup`` subclasses ``TorchGroup`` as ``PallasGroup`` subclasses
``XLAGroup``: the control plane (the coordinator, the gloo group, the
barrier, send / recv) is the parent's, and the group also exchanges the
ring's workspace handles through the coordinator. The data plane:

- ``device_allreduce(x, op, quantized=)`` and ``ring_collective(kind, x)``
  for the four kinds of the reference's ``_ring_fn``: ``allreduce`` (C4),
  ``quantized_allreduce`` (C6, with the int8 ring's fallback ladder),
  ``allgather`` (C3) and ``reducescatter`` (C2). Each takes this rank's
  tensor and returns this rank's row of the rank-major function
  (``ring_allreduce`` etc.) on the ranks' stacked tensors. On the card
  each rank launches its own part (``process_ring.py``); on the CPU
  (``device="cpu"``) the plain ring functions run over the stack gathered
  through gloo, so the CPU path has the ring's bits.
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
    ring_qallreduce_rank_cuda, ring_reduce_scatter_rank_cuda,
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


class CudaGroup(TorchGroup):
    """Collective group whose device-side ops are the port's ring kernels,
    one process per rank."""

    backend_name = "cuda"

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

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """The rank-major stack the plain functions run on: every rank's
        tensor through gloo on the CPU, x alone in a group of one."""
        if self.world_size == 1:
            return x[None]
        return self._gather_tensors(x)

    def ring_collective(self, kind: str, tensor,
                        op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        """One of the reference's ``_ring_fn`` kinds on this rank's tensor;
        returns this rank's result (allgather: [n, *shape])."""
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
            return fn(stack)[self.rank]
        if kind == "allgather":
            return ring_allgather_rank_cuda(x, ring=self.ring)
        if kind == "quantized_allreduce":
            name = Q._check_args(x, name, "allreduce", "ring_allreduce")
            if Q._wants_bf16(x[None]):
                return self.ring_collective(
                    "allreduce", x.to(torch.bfloat16), op).to(x.dtype)
            out = ring_qallreduce_rank_cuda(x.to(torch.float32),
                                            ring=self.ring).to(x.dtype)
        elif kind == "allreduce":
            out = ring_allreduce_rank_cuda(
                x, "sum" if name == "avg" else name, ring=self.ring)
        else:
            out = ring_reduce_scatter_rank_cuda(
                x, "sum" if name == "avg" else name, ring=self.ring)
        return out / self.world_size if name == "avg" else out

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
