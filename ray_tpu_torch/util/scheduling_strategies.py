"""Per-task scheduling strategies
(reference: `python/ray/util/scheduling_strategies.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "object"  # ray_tpu_torch.util.placement_group.PlacementGroup
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: bytes
    soft: bool = False

    def __post_init__(self):
        if isinstance(self.node_id, str):
            self.node_id = bytes.fromhex(self.node_id)


@dataclass
class NodeLabelSchedulingStrategy:
    hard: Optional[Dict[str, List[str]]] = None
    soft: Optional[Dict[str, List[str]]] = None
