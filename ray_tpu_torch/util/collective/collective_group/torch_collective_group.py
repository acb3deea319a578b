"""The ``torch`` collective backend: ``torch.distributed`` over gloo on host
tensors, the port's counterpart of the reference's ``XLAGroup``
(``ray_tpu/util/collective/collective_group/xla_collective_group.py``).

- Rendezvous: a named coordinator actor (the ``NCCLUniqueIDStore``
  pattern). Rank 0 opens a ``TCPStore`` on a free port and publishes its
  ``host:port`` through the coordinator, as ``_init_jax_distributed``
  publishes the jax coordinator; every member then forms a gloo process
  group of its own over that store (``ProcessGroupGloo``), so it coexists
  with a default group that a trainer's backend may have formed.
- Host-level ops reproduce ``XLAGroup``'s arithmetic exactly: gather every
  rank's tensor (``allgather``) into a rank-major stack, then numpy's
  ``sum`` / ``prod`` / ``min`` / ``max`` / ``mean`` over axis 0,
  ``np.array_split`` for ``reducescatter``; ``reduce`` returns the input on
  ranks other than ``dst``. Results are numpy arrays, as the reference's.
- ``send`` / ``recv`` go through the coordinator's mailboxes, tagged in
  sequence per (src, dst) pair (the reference's one fixed tag lets a
  second send overwrite an unread first).
- No device mesh: ``get_group_mesh`` refuses a ``torch`` group, as the
  reference refuses its host groups (the ``cuda`` group has one).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.util.collective.collective_group.base_collective_group \
    import BaseGroup
from ray_tpu_torch.util.collective.types import ReduceOp
from ray_tpu_torch.util.collective.util import get_or_create_coordinator


def _host_tensor(tensor) -> torch.Tensor:
    """A contiguous CPU tensor holding ``tensor`` (numpy or a tensor)."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().contiguous()
    arr = np.ascontiguousarray(np.asarray(tensor))
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


class TorchGroup(BaseGroup):
    backend_name = "torch"

    def __init__(self, world_size: int, rank: int, group_name: str,
                 timeout_s: float = 300.0):
        super().__init__(world_size, rank, group_name)
        self._timeout = float(timeout_s)
        self._hub = get_or_create_coordinator(group_name, world_size)
        self._gen = ray_tpu_torch.get(self._hub.join.remote(rank),
                                      timeout=self._timeout)
        self._p2p_counters: dict = {}
        self._store = self._pg = None
        self._init_process_group()

    # ------------------------------------------------------------ rendezvous
    def _init_process_group(self) -> None:
        if self.world_size == 1:
            return          # one process: no process group
        import torch.distributed as dist

        key = f"torch_store:{self._gen}"
        timeout = datetime.timedelta(seconds=self._timeout)
        if self.rank == 0:
            host = os.environ.get("RAY_TPU_NODE_IP") or "127.0.0.1"
            self._store = dist.TCPStore(host, 0, self.world_size, True,
                                        timeout=timeout,
                                        wait_for_workers=False)
            ray_tpu_torch.get(self._hub.put.remote(
                key, f"{host}:{self._store.port}"), timeout=60)
        else:
            addr = ray_tpu_torch.get(self._hub.get.remote(key, self._timeout),
                                     timeout=self._timeout + 10)
            if addr is None:
                raise TimeoutError(
                    f"rank 0 of collective group {self.group_name!r} never "
                    f"published its store address")
            host, port = addr.rsplit(":", 1)
            self._store = dist.TCPStore(host, int(port), self.world_size,
                                        False, timeout=timeout)
        self._pg = dist.ProcessGroupGloo(self._store, self.rank,
                                         self.world_size, timeout)

    # ---------------------------------------------------- host-level parity
    def _gather_tensors(self, tensor) -> torch.Tensor:
        """Every rank's tensor, stacked rank-major: [n, ...] on the CPU."""
        t = _host_tensor(tensor)
        if self.world_size == 1:
            return t[None]
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        self._pg.allgather([outs], [t]).wait()
        return torch.stack(outs)

    def _gather_stack(self, tensor) -> np.ndarray:
        return self._gather_tensors(tensor).numpy()

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        gathered = self._gather_stack(tensor)
        if op == ReduceOp.SUM:
            return gathered.sum(axis=0)
        if op == ReduceOp.PRODUCT:
            return gathered.prod(axis=0)
        if op == ReduceOp.MIN:
            return gathered.min(axis=0)
        if op == ReduceOp.MAX:
            return gathered.max(axis=0)
        if op == ReduceOp.AVERAGE:
            return gathered.mean(axis=0)
        raise ValueError(f"unsupported op {op}")

    def barrier(self):
        if self.world_size > 1:
            self._pg.barrier().wait()

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        out = self.allreduce(tensor, op)
        return out if self.rank == dst_rank else tensor

    def broadcast(self, tensor, src_rank: int = 0):
        gathered = self._gather_stack(tensor)
        return gathered[src_rank]

    def allgather(self, tensor) -> List[Any]:
        gathered = self._gather_stack(tensor)
        return [gathered[r] for r in range(self.world_size)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        full = self.allreduce(tensor, op)
        return np.array_split(full, self.world_size, axis=0)[self.rank]

    def _p2p_tag(self, src: int, dst: int) -> str:
        n = self._p2p_counters.get((src, dst), 0) + 1
        self._p2p_counters[(src, dst)] = n
        return f"{self._gen}:torch_p2p:{n}"

    def _send_payload(self, tensor):
        return np.asarray(tensor)

    def send(self, tensor, dst_rank: int):
        ray_tpu_torch.get(self._hub.send.remote(
            self.rank, dst_rank, self._p2p_tag(self.rank, dst_rank),
            self._send_payload(tensor)), timeout=self._timeout)

    def recv(self, src_rank: int):
        return ray_tpu_torch.get(self._hub.recv.remote(
            src_rank, self.rank, self._p2p_tag(src_rank, self.rank),
            self._timeout), timeout=self._timeout + 10)

    def destroy(self):
        self._pg = self._store = None
