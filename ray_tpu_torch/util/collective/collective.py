"""Collective communication API: the port's copy of
``ray_tpu/util/collective/collective.py``.

Function-for-function parity with the reference's
``util/collective/collective.py`` (``init_collective_group :40``,
``create_collective_group :120``, ``allreduce :258``, ``barrier :298``,
``reduce :311``, ``broadcast :373``, ``allgather :423``,
``reducescatter :472``, ``send :531``, ``recv :594``), on the port's
backends: ``cuda`` (the ring kernels, one process per rank on the card;
CUDA tensors in and out), ``torch`` (``torch.distributed`` over gloo) and
``shm`` (the coordinator hub); the last two take CPU tensors or numpy and
return numpy, as the reference's host paths do.

The ranks are actors (or tasks) of the port's runtime. The calling process's
``create_collective_group(actors, ...)`` calls each actor's
``_init_collective(world_size, rank, backend, group_name)``, which calls
``init_collective_group`` in the actor's process (with whatever options
the actor passes: ``device``, ``quantized``, ``timeout_s``,
``wait_timeout_s``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

from ray_tpu_torch.util.collective.types import Backend, ReduceOp


class GroupManager:
    """Per-process registry of collective groups (reference `GroupManager`)."""

    def __init__(self):
        self._groups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_group(self, backend: str, world_size: int, rank: int,
                     group_name: str, **options):
        backend = Backend.validate(backend)
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(
                    f"collective group {group_name!r} already initialized in "
                    "this process")
        if backend == Backend.TORCH:
            from ray_tpu_torch.util.collective.collective_group \
                .torch_collective_group import TorchGroup

            group = TorchGroup(world_size, rank, group_name, **options)
        elif backend == Backend.CUDA:
            from ray_tpu_torch.util.collective.collective_group \
                .cuda_collective_group import CudaGroup

            group = CudaGroup(world_size, rank, group_name, **options)
        else:
            from ray_tpu_torch.util.collective.collective_group \
                .shm_collective_group import SHMGroup

            group = SHMGroup(world_size, rank, group_name, **options)
        with self._lock:
            self._groups[group_name] = group
        return group

    def get_group(self, group_name: str):
        group = self._groups.get(group_name)
        if group is None:
            raise RuntimeError(
                f"collective group {group_name!r} is not initialized in this "
                "process; call init_collective_group first")
        return group

    def is_group_initialized(self, group_name: str) -> bool:
        return group_name in self._groups

    def destroy_group(self, group_name: str):
        group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_group_mgr = GroupManager()


def init_collective_group(world_size: int, rank: int,
                          backend: str = Backend.CUDA,
                          group_name: str = "default", **options) -> None:
    """Initialize this process's membership in a collective group.

    Call from inside each participating actor/task (reference
    `collective.py:40`)."""
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    _group_mgr.create_group(backend, world_size, rank, group_name, **options)


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int], backend: str = Backend.CUDA,
                            group_name: str = "default") -> None:
    """Driver-side declaration: make every actor join the group
    (reference `collective.py:120`). Blocks until all members are in."""
    import ray_tpu_torch

    if len(actors) != world_size or sorted(ranks) != list(range(world_size)):
        raise ValueError("need exactly world_size actors with ranks 0..n-1")
    refs = [
        actor._init_collective.remote(world_size, rank, backend, group_name)
        for actor, rank in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs, timeout=300)


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.is_group_initialized(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    _group_mgr.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).world_size


def get_group_mesh(group_name: str = "default", axis_name: str = "x"):
    """The reference's TPU-native extension: the group's mesh. On a
    ``cuda`` group a 1-D ``parallel.Mesh`` over its ranks (one process
    and one card per rank); the host backends have none."""
    group = _group_mgr.get_group(group_name)
    if not hasattr(group, "get_mesh"):
        raise RuntimeError(
            f"group {group_name!r} uses backend without a device mesh; use "
            "backend='cuda'")
    return group.get_mesh(axis_name)


# ---------------------------------------------------------------------------
# Collective ops (value-returning, as the reference's). Every op is
# metered: rtpu_collective_{ops,bytes}_total{op,backend,dtype}, an
# op-latency histogram and a `collective:<op>` span.
# ---------------------------------------------------------------------------

def _backend_name(group) -> str:
    return getattr(group, "backend_name", type(group).__name__.lower()
                   .replace("group", ""))


def _observed(op_name: str, group, tensor=None):
    from ray_tpu_torch.observability.collective import observe_collective

    return observe_collective(op_name, _backend_name(group), tensor)


def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    with _observed("allreduce", group, tensor):
        return group.allreduce(tensor, op)


def barrier(group_name: str = "default") -> None:
    group = _group_mgr.get_group(group_name)
    with _observed("barrier", group):
        group.barrier()


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    with _observed("reduce", group, tensor):
        return group.reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    with _observed("broadcast", group, tensor):
        return group.broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default") -> List[Any]:
    group = _group_mgr.get_group(group_name)
    with _observed("allgather", group, tensor):
        return group.allgather(tensor)


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    group = _group_mgr.get_group(group_name)
    with _observed("reducescatter", group, tensor):
        return group.reducescatter(tensor, op)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    group = _group_mgr.get_group(group_name)
    with _observed("send", group, tensor):
        group.send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    group = _group_mgr.get_group(group_name)
    with _observed("recv", group):
        return group.recv(src_rank)
