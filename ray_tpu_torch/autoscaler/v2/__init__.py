"""Autoscaler v2 — declarative, crash-resilient instance management.

Reference: `python/ray/autoscaler/v2/` (`instance_manager/
instance_manager.py`, `instance_manager/reconciler.py`,
`instance_storage.py`): instances are rows in a versioned table with an
explicit lifecycle state machine; one Reconciler pass diffs desired
vs. observed (cloud + ray) state and issues the transitions.  The table
persists in the GCS KV, so an autoscaler crash/restart resumes exactly
where it left off — the property v1's in-memory loop lacks.
"""

from ray_tpu_torch.autoscaler.v2.instance_manager import (
    Instance, InstanceManager, InstanceStatus,
)
from ray_tpu_torch.autoscaler.v2.reconciler import Reconciler

__all__ = ["Instance", "InstanceManager", "InstanceStatus", "Reconciler"]
