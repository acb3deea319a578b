"""Backend interface: the port's copy of
``ray_tpu/util/collective/collective_group/base_collective_group.py``
(reference: ``collective_group/base_collective_group.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List

from ray_tpu_torch.util.collective.types import ReduceOp


class BaseGroup(ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name

    @abstractmethod
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM): ...

    @abstractmethod
    def barrier(self): ...

    @abstractmethod
    def reduce(self, tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM): ...

    @abstractmethod
    def broadcast(self, tensor, src_rank: int = 0): ...

    @abstractmethod
    def allgather(self, tensor) -> List[Any]: ...

    @abstractmethod
    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM): ...

    @abstractmethod
    def send(self, tensor, dst_rank: int): ...

    @abstractmethod
    def recv(self, src_rank: int): ...

    def destroy(self):
        pass
