"""Ring collectives of the port over n virtual ranks (the port of
``ray_tpu/util/collective/pallas``), and ``RingGroup``.

Rank-major API: rank r's shard is ``x[r]``::

    ring_allreduce(x, op)            # [n, ...] -> [n, ...]      (C4)
    ring_allgather(x)                # [n, ...] -> [n, n, ...]   (C3)
    ring_reduce_scatter(x, op)       # [n, n*k, ...] -> [n, k, ...] (C2)
    select_impl(...)                 # auto -> cuda | plain

Split-phase (one hop per C1 launch; every start balanced by a wait)::

    h = start_ring_reduce_scatter(x)   # hop 0 on the comm stream
    y = heavy_compute(...)             # runs beside the hops
    shard = wait_ring_reduce_scatter(h)
    start_ring_allgather / wait_ring_allgather
    start_ring_permute / wait_ring_permute

The int8 ring (``quantized.py``; every hop requantizes to int8 with one
scale per chunk)::

    quantized_ring_allreduce(x, op)  # [n, ...] -> [n, ...]      (C6)
    h = start_quantized_ring_reduce_scatter(x)   # one C5 launch per hop
    shard = wait_quantized_ring_reduce_scatter(h)
    local_quantization_residual(block, n)        # error feedback
"""

from ray_tpu_torch.util.collective.group import RingGroup, default_group
from ray_tpu_torch.util.collective.ring import (
    LANES, SplitPhaseHandle, ring_allgather, ring_allreduce,
    ring_reduce_scatter, select_impl, start_ring_allgather,
    start_ring_permute, start_ring_reduce_scatter, wait_ring_allgather,
    wait_ring_permute, wait_ring_reduce_scatter,
)
from ray_tpu_torch.util.collective.quantized import (
    local_quantization_residual, quantized_ring_allreduce,
    start_quantized_ring_reduce_scatter, wait_quantized_ring_reduce_scatter,
)
from ray_tpu_torch.util.collective.types import ReduceOp

__all__ = [
    "ring_allreduce", "ring_allgather", "ring_reduce_scatter",
    "quantized_ring_allreduce", "select_impl", "SplitPhaseHandle",
    "start_ring_reduce_scatter", "wait_ring_reduce_scatter",
    "start_ring_allgather", "wait_ring_allgather",
    "start_ring_permute", "wait_ring_permute",
    "start_quantized_ring_reduce_scatter",
    "wait_quantized_ring_reduce_scatter",
    "local_quantization_residual", "RingGroup", "default_group",
    "ReduceOp", "LANES",
]
