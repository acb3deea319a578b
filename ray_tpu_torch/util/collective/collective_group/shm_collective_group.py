"""SHM (CPU) collective backend, the gloo-equivalent for host tensors: the
port's copy of ``ray_tpu/util/collective/collective_group/
shm_collective_group.py``.

Reference analogue: ``collective_group/gloo_collective_group.py``. Data
plane: every collective is a gather round through the group's named
coordinator actor; payloads ride the object store (shared memory on the
node). Results are numpy arrays, reduced in numpy's order (``_reduce``),
so they equal the reference's bit for bit. ``timeout_s`` bounds every
round (the reference's fixed 300 s is the default). Rounds and mailboxes
are keyed by the member's join generation (``CollectiveCoordinator.join``),
so a group destroyed and made again under its name starts clean.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.util.collective.collective_group.base_collective_group \
    import BaseGroup
from ray_tpu_torch.util.collective.types import ReduceOp
from ray_tpu_torch.util.collective.util import (
    _reduce, get_or_create_coordinator,
)


class SHMGroup(BaseGroup):
    backend_name = "shm"

    def __init__(self, world_size: int, rank: int, group_name: str,
                 timeout_s: float = 300.0):
        super().__init__(world_size, rank, group_name)
        self._timeout = float(timeout_s)
        self._hub = get_or_create_coordinator(group_name, world_size)
        self._gen = ray_tpu_torch.get(self._hub.join.remote(rank),
                                      timeout=self._timeout)
        self._op_counter = 0
        # Point-to-point tags sequence per (src, dst) pair so a sender's Nth
        # send matches the receiver's Nth recv from that sender.
        self._p2p_counters: dict = {}

    def _next_uid(self, kind: str) -> str:
        # All ranks issue collectives in the same order (SPMD contract), so a
        # per-rank counter yields matching uids across the group.
        self._op_counter += 1
        return f"{self._gen}:{kind}:{self._op_counter}"

    def _round(self, kind: str, payload) -> dict:
        uid = self._next_uid(kind)
        return ray_tpu_torch.get(
            self._hub.gather_round.remote(uid, self.rank, payload,
                                          self._timeout),
            timeout=self._timeout + 10)

    # ------------------------------------------------------------------ ops
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        data = self._round("allreduce", np.asarray(tensor))
        return _reduce([data[r] for r in range(self.world_size)], op)

    def barrier(self):
        self._round("barrier", None)

    def reduce(self, tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        data = self._round("reduce", np.asarray(tensor))
        if self.rank == dst_rank:
            return _reduce([data[r] for r in range(self.world_size)], op)
        return tensor

    def broadcast(self, tensor, src_rank: int = 0):
        payload = np.asarray(tensor) if self.rank == src_rank else None
        data = self._round("broadcast", payload)
        return data[src_rank]

    def allgather(self, tensor) -> List[Any]:
        data = self._round("allgather", np.asarray(tensor))
        return [data[r] for r in range(self.world_size)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        data = self._round("reducescatter", np.asarray(tensor))
        full = _reduce([data[r] for r in range(self.world_size)], op)
        chunks = np.array_split(full, self.world_size, axis=0)
        return chunks[self.rank]

    def _p2p_tag(self, src: int, dst: int) -> str:
        n = self._p2p_counters.get((src, dst), 0) + 1
        self._p2p_counters[(src, dst)] = n
        return f"{self._gen}:t{n}"

    def send(self, tensor, dst_rank: int):
        tag = self._p2p_tag(self.rank, dst_rank)
        ray_tpu_torch.get(self._hub.send.remote(
            self.rank, dst_rank, tag, np.asarray(tensor)),
            timeout=self._timeout)

    def recv(self, src_rank: int):
        tag = self._p2p_tag(src_rank, self.rank)
        return ray_tpu_torch.get(self._hub.recv.remote(
            src_rank, self.rank, tag, self._timeout),
            timeout=self._timeout + 10)
