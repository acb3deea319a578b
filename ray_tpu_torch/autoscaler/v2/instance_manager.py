"""Instance table + lifecycle state machine.

Reference: `autoscaler/v2/instance_manager/instance_manager.py` (the
versioned instance table with expected-version CAS updates) and
`common.py` InstanceStatus.  Statuses and legal transitions mirror the
reference's machine, trimmed to the states this runtime has observable
signals for:

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                                     -> RAY_STOPPING -> TERMINATING
    any    -> ALLOCATION_FAILED / TERMINATED

The table lives in the GCS KV under one key, written atomically with a
version counter: a crashed autoscaler process reloads the exact table
(including in-flight REQUESTED instances) on restart.
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid
from typing import Any, Dict, List, Optional

KV_KEY = "autoscaler_v2/instances"


class InstanceStatus:
    QUEUED = "QUEUED"                  # decided, not yet requested
    REQUESTED = "REQUESTED"            # create_node issued
    ALLOCATED = "ALLOCATED"            # cloud says it exists
    RAY_RUNNING = "RAY_RUNNING"        # node registered with the GCS
    RAY_STOPPING = "RAY_STOPPING"      # drain requested
    TERMINATING = "TERMINATING"        # terminate_node issued
    TERMINATED = "TERMINATED"          # gone (terminal)
    ALLOCATION_FAILED = "ALLOCATION_FAILED"  # create failed (terminal)


_LEGAL = {
    InstanceStatus.QUEUED: {InstanceStatus.REQUESTED,
                            InstanceStatus.TERMINATED},
    InstanceStatus.REQUESTED: {InstanceStatus.ALLOCATED,
                               InstanceStatus.ALLOCATION_FAILED,
                               InstanceStatus.TERMINATED},
    InstanceStatus.ALLOCATED: {InstanceStatus.RAY_RUNNING,
                               InstanceStatus.RAY_STOPPING,
                               InstanceStatus.TERMINATING,
                               InstanceStatus.TERMINATED},
    InstanceStatus.RAY_RUNNING: {InstanceStatus.RAY_STOPPING,
                                 InstanceStatus.TERMINATING,
                                 InstanceStatus.TERMINATED},
    InstanceStatus.RAY_STOPPING: {InstanceStatus.TERMINATING,
                                  InstanceStatus.TERMINATED},
    InstanceStatus.TERMINATING: {InstanceStatus.TERMINATED},
    InstanceStatus.TERMINATED: set(),
    InstanceStatus.ALLOCATION_FAILED: set(),
}


@dataclasses.dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = InstanceStatus.QUEUED
    # provider id once REQUESTED succeeds; cluster NodeID hex once joined
    cloud_instance_id: Optional[str] = None
    node_id: Optional[str] = None
    status_since: float = dataclasses.field(default_factory=time.time)
    history: List[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def new(node_type: str) -> "Instance":
        return Instance(instance_id=uuid.uuid4().hex[:12],
                        node_type=node_type)

    def to_row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_row(row: Dict[str, Any]) -> "Instance":
        return Instance(**row)


class InvalidTransition(Exception):
    pass


class InstanceManager:
    """The versioned instance table, persisted in the GCS KV.

    All mutations go through `transition` / `add`, which write the whole
    table back with `version+1` — a concurrent writer (e.g. a split-
    brain autoscaler) loses by version check on the next reload, which
    is the reference's expected-version CAS semantics flattened to the
    single-writer deployment this runtime uses."""

    def __init__(self, kv_get, kv_put):
        self._kv_get = kv_get
        self._kv_put = kv_put
        self.version = 0
        self.instances: Dict[str, Instance] = {}
        self._load()

    # ----------------------------------------------------------- storage
    def _load(self) -> None:
        raw = self._kv_get(KV_KEY)
        if not raw:
            return
        doc = json.loads(raw if isinstance(raw, str) else raw.decode())
        self.version = doc["version"]
        self.instances = {r["instance_id"]: Instance.from_row(r)
                          for r in doc["instances"]}

    def _flush(self) -> None:
        self.version += 1
        doc = {"version": self.version,
               "instances": [i.to_row() for i in self.instances.values()]}
        self._kv_put(KV_KEY, json.dumps(doc))

    # --------------------------------------------------------- mutations
    def add(self, node_type: str) -> Instance:
        inst = Instance.new(node_type)
        inst.history.append(f"{InstanceStatus.QUEUED}@{inst.status_since:.0f}")
        self.instances[inst.instance_id] = inst
        self._flush()
        return inst

    def transition(self, instance_id: str, new_status: str,
                   **fields) -> Instance:
        inst = self.instances[instance_id]
        if new_status not in _LEGAL[inst.status]:
            raise InvalidTransition(
                f"{inst.instance_id}: {inst.status} -> {new_status}")
        inst.status = new_status
        inst.status_since = time.time()
        inst.history.append(f"{new_status}@{inst.status_since:.0f}")
        for k, v in fields.items():
            setattr(inst, k, v)
        self._flush()
        return inst

    # ------------------------------------------------------------ views
    def with_status(self, *statuses: str) -> List[Instance]:
        return [i for i in self.instances.values() if i.status in statuses]

    def active(self) -> List[Instance]:
        """Instances that exist or will exist (count against limits)."""
        return self.with_status(
            InstanceStatus.QUEUED, InstanceStatus.REQUESTED,
            InstanceStatus.ALLOCATED, InstanceStatus.RAY_RUNNING)

    def by_cloud_id(self, cloud_instance_id: str) -> Optional[Instance]:
        for i in self.instances.values():
            if i.cloud_instance_id == cloud_instance_id:
                return i
        return None
