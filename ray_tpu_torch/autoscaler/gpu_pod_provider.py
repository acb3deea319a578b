"""Gang node provider: all hosts of a GPU gang, or none.

Reference: `python/ray/autoscaler/node_provider.py` is per-node, and the
reference's `tpu_pod_provider.py` makes a TPU pod slice its unit. A
multi-host GPU gang (``H100-16``: two hosts of eight cards that train as
one torch.distributed world) is the same kind of unit: its hosts are
useful only together. So the provider's unit here is the *node group*:
`create_node_group` launches every host of a gang and rolls back on
partial failure; `terminate_node_group` tears the gang down as one.

`SubprocessPodProvider` implements the interface with local raylet
processes (the test/e2e backend, the analogue of
`fake_multi_node/node_provider.py`); a cloud implementation maps a group
to one bulk instance creation (`gcp_gpu_provider.py`).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider, start_node, stop_node,
)


class PodGroupProvider(NodeProvider):
    """NodeProvider extended with atomic node-group (gang) ops.

    Single-node types degrade to groups of size 1, so the autoscaler can
    treat everything as groups.
    """

    def create_node_group(self, node_type: str,
                          node_config: Dict[str, Any],
                          gang_size: int) -> str:
        """Launch `gang_size` hosts atomically; returns a group id.
        Partial failures must roll back (terminate already-started hosts)
        and raise."""
        raise NotImplementedError

    def terminate_node_group(self, group_id: str) -> None:
        raise NotImplementedError

    def node_groups(self) -> List[str]:
        raise NotImplementedError

    def group_nodes(self, group_id: str) -> List[str]:
        """Provider node ids of the group's hosts."""
        raise NotImplementedError

    def group_type_of(self, group_id: str) -> Optional[str]:
        raise NotImplementedError


class SubprocessPodProvider(PodGroupProvider):
    """GPU gangs as gangs of local raylet processes.

    Host 0 of each group additionally exposes the promoted
    ``GPU-{type}-{count}-head`` resource (when the node type declares
    one), so a single head-resource task gang-schedules against the gang.
    """

    def __init__(self, gcs_addr, session_dir: str):
        self._gcs_addr = tuple(gcs_addr)
        self._session_dir = session_dir
        self._lock = threading.Lock()
        self._groups: Dict[str, List[str]] = {}
        self._group_types: Dict[str, str] = {}
        self._nodes: Dict[str, Any] = {}      # provider node id -> Node
        self._node_types: Dict[str, str] = {}

    # ---- group ops --------------------------------------------------------
    def create_node_group(self, node_type: str,
                          node_config: Dict[str, Any],
                          gang_size: int) -> str:
        group_id = f"group-{node_type}-{uuid.uuid4().hex[:6]}"
        started: List[str] = []
        try:
            for host_index in range(gang_size):
                resources = dict(node_config.get("resources", {}))
                if host_index == 0:
                    resources.update(node_config.get("head_resources", {}))
                labels = {"autoscaler-node-type": node_type,
                          "pod-group": group_id,
                          "pod-host-index": str(host_index)}
                node = start_node(self._gcs_addr, self._session_dir,
                                  resources, labels)
                pid = f"{group_id}-host{host_index}"
                with self._lock:
                    self._nodes[pid] = node
                    self._node_types[pid] = node_type
                started.append(pid)
        except Exception:
            # All-or-nothing: a partly-up gang is useless (its
            # torch.distributed world needs every host); roll back what
            # started.
            for pid in started:
                self._terminate_node_internal(pid)
            raise
        with self._lock:
            self._groups[group_id] = started
            self._group_types[group_id] = node_type
        return group_id

    def terminate_node_group(self, group_id: str) -> None:
        with self._lock:
            pids = self._groups.pop(group_id, [])
            self._group_types.pop(group_id, None)
        for pid in pids:
            self._terminate_node_internal(pid)

    def node_groups(self) -> List[str]:
        with self._lock:
            return list(self._groups)

    def group_nodes(self, group_id: str) -> List[str]:
        with self._lock:
            return list(self._groups.get(group_id, []))

    def group_type_of(self, group_id: str) -> Optional[str]:
        return self._group_types.get(group_id)

    # ---- per-node view (NodeProvider interface) ---------------------------
    def create_node(self, node_type: str,
                    node_config: Dict[str, Any]) -> str:
        return self.create_node_group(node_type, node_config, 1)

    def terminate_node(self, provider_node_id: str) -> None:
        # A single host of a gang cannot be terminated alone; terminate
        # the containing group (or the id may itself be a group id).
        if provider_node_id in self._groups:
            self.terminate_node_group(provider_node_id)
            return
        with self._lock:
            owner = next((g for g, pids in self._groups.items()
                          if provider_node_id in pids), None)
        if owner is not None:
            self.terminate_node_group(owner)

    def _terminate_node_internal(self, pid: str) -> None:
        with self._lock:
            node = self._nodes.pop(pid, None)
            self._node_types.pop(pid, None)
        if node is not None:
            stop_node(self._gcs_addr, node)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def node_type_of(self, provider_node_id: str) -> Optional[str]:
        return self._node_types.get(provider_node_id)

    def internal_node_id(self, provider_node_id: str) -> Optional[bytes]:
        node = self._nodes.get(provider_node_id)
        return node.node_id.binary() if node is not None else None

    def shutdown(self) -> None:
        for gid in list(self._groups):
            self.terminate_node_group(gid)
        for pid in list(self._nodes):
            self._terminate_node_internal(pid)
