"""Accelerator abstraction (reference: `_private/accelerators/accelerator.py:5`).

An AcceleratorManager knows how to: detect how many accelerators this node
has, name their type, read/set the process-level visibility env var, and
validate per-task request quantities.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional


class AcceleratorManager(ABC):
    @staticmethod
    @abstractmethod
    def get_resource_name() -> str:
        """Resource name used in the scheduler (e.g. "GPU")."""

    @staticmethod
    @abstractmethod
    def get_visible_accelerator_ids_env_var() -> str:
        """Env var controlling per-process accelerator visibility."""

    @staticmethod
    @abstractmethod
    def get_current_node_num_accelerators() -> int:
        """Autodetect this node's accelerator count."""

    @staticmethod
    @abstractmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """E.g. "H100" / "A100"."""

    @staticmethod
    @abstractmethod
    def validate_resource_request_quantity(quantity: float
                                           ) -> "tuple[bool, Optional[str]]":
        """(valid, error_message)."""

    @staticmethod
    @abstractmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        ...

    @staticmethod
    def get_current_node_extra_resources() -> Dict[str, float]:
        """Additional custom resources this accelerator contributes (e.g.
        ``GPU-H100``)."""
        return {}
