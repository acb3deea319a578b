"""Collective types: the port's copy of ``ray_tpu/util/collective/types.py``
(reference: ``python/ray/util/collective/types.py``), with the port's
backend names.

Backends:

- ``cuda``: the hand-written ring kernels (``ops/csrc/ring.cu``), one
  process per rank on the card; the counterpart of the reference's
  ``pallas``.
- ``torch``: ``torch.distributed`` over gloo on host tensors; the
  counterpart of the reference's ``xla``.
- ``shm``: the coordinator actor's gather rounds on host tensors (aliases
  ``gloo`` and ``cpu``, as in the reference).

The reference's ``xla`` and ``pallas`` raise, naming these.
"""

from __future__ import annotations

import enum


class Backend:
    CUDA = "cuda"      # hand-written ring kernels, one process per rank
    TORCH = "torch"    # torch.distributed over gloo on host tensors
    SHM = "shm"        # hub-actor CPU backend (gloo-equivalent)
    # Alias kept for API familiarity with the reference ("gloo" on CPU).
    GLOO = "shm"

    @staticmethod
    def validate(name: str) -> str:
        if name == Backend.CUDA:
            return Backend.CUDA
        if name == Backend.TORCH:
            return Backend.TORCH
        if name in ("shm", "gloo", "cpu"):
            return Backend.SHM
        if name in ("xla", "pallas"):
            raise ValueError(
                f"collective backend {name!r} is the JAX package's; the "
                "port's are 'torch' (torch.distributed over gloo, for "
                "'xla') and 'cuda' (the ring kernels on the card, for "
                "'pallas')")
        raise ValueError(
            f"unknown collective backend {name!r}; ray_tpu_torch supports "
            "'cuda' (the ring kernels on the card, one process per rank), "
            "'torch' (torch.distributed over gloo on host tensors) and "
            "'shm'/'gloo' (host tensors through the coordinator actor)")


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVERAGE = 4
