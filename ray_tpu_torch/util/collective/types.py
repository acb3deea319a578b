"""Collective types: the port's copy of ``ReduceOp`` from
``ray_tpu/util/collective/types.py`` (reference:
``python/ray/util/collective/types.py``)."""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVERAGE = 4
