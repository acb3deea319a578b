"""NodeProvider — the pluggable infrastructure backend of the autoscaler.

Reference: `python/ray/autoscaler/node_provider.py` (the ABC all cloud
providers implement) and the fake in-process provider used for autoscaler
e2e tests without a cloud
(`autoscaler/_private/fake_multi_node/node_provider.py`).

A node type's ``GPU`` resource becomes the node's ``num_gpus``, passed
explicitly even when it is 0: the port's ``Node`` counts the host's cards
when ``num_gpus`` is None, so a CPU node type would otherwise claim them.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Creates/terminates worker nodes of named types."""

    def create_node(self, node_type: str,
                    node_config: Dict[str, Any]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_type_of(self, provider_node_id: str) -> Optional[str]:
        raise NotImplementedError

    def internal_node_id(self, provider_node_id: str) -> Optional[bytes]:
        """The cluster NodeID once the node has joined, else None."""
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class GcsNodeTableMixin:
    """TTL-cached GCS node snapshot for cloud providers that resolve
    provider node ids to cluster NodeIDs (shared by the Compute Engine GPU
    and KubeRay providers; one fetch serves a whole reconcile pass)."""

    _gcs_addr: Optional[tuple] = None
    _NODE_TABLE_TTL_S = 2.0

    def _node_table(self):
        if self._gcs_addr is None:
            return None
        import time

        now = time.monotonic()
        cached = getattr(self, "_node_table_cache", None)
        if cached is not None and now - cached[0] < self._NODE_TABLE_TTL_S:
            return cached[1]
        try:
            from ray_tpu_torch._private.rpc import RpcClient

            gcs = RpcClient(*self._gcs_addr)
            try:
                nodes = gcs.call("get_all_nodes", timeout=10)
            finally:
                gcs.close()
        except Exception:
            return None
        self._node_table_cache = (now, nodes)
        return nodes


def start_node(gcs_addr, session_dir: str, resources: Dict[str, Any],
               labels: Dict[str, str]):
    """A worker node's daemons on this machine, with the node type's
    ``CPU`` and ``GPU`` given explicitly (a missing ``GPU`` is 0)."""
    from ray_tpu_torch._private import node as node_mod

    resources = dict(resources)
    num_cpus = resources.pop("CPU", 1)
    num_gpus = resources.pop("GPU", 0)
    return node_mod.Node(head=False, gcs_addr=gcs_addr, num_cpus=num_cpus,
                         num_gpus=num_gpus, resources=resources,
                         session_dir=session_dir, labels=labels)


def stop_node(gcs_addr, node) -> None:
    """Stop a node's daemons, then tell the GCS that it was removed on
    purpose (``drain_node``): its resources leave the cluster at once,
    where the health check would mark it dead seconds later, as a
    failure. Draining after the stop leaves the raylet no heartbeat to
    send in between."""
    node.shutdown(cleanup_session=False)
    try:
        from ray_tpu_torch._private.rpc import RpcClient

        gcs = RpcClient(*gcs_addr)
        try:
            gcs.call("drain_node", node_id=node.node_id.binary(), timeout=10)
        finally:
            gcs.close()
    except Exception:
        pass


class FakeMultiNodeProvider(NodeProvider):
    """Starts real raylet processes on this machine as 'cloud nodes' —
    scale-up/down runs the true join/leave path with no cloud."""

    def __init__(self, gcs_addr, session_dir: str):
        self._gcs_addr = tuple(gcs_addr)
        self._session_dir = session_dir
        self._nodes: Dict[str, Any] = {}      # provider id -> Node
        self._types: Dict[str, str] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: str,
                    node_config: Dict[str, Any]) -> str:
        node = start_node(self._gcs_addr, self._session_dir,
                          node_config.get("resources", {}),
                          {"autoscaler-node-type": node_type})
        pid = f"fake-{node_type}-{uuid.uuid4().hex[:6]}"
        with self._lock:
            self._nodes[pid] = node
            self._types[pid] = node_type
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(provider_node_id, None)
            self._types.pop(provider_node_id, None)
        if node is not None:
            stop_node(self._gcs_addr, node)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def node_type_of(self, provider_node_id: str) -> Optional[str]:
        return self._types.get(provider_node_id)

    def internal_node_id(self, provider_node_id: str) -> Optional[bytes]:
        node = self._nodes.get(provider_node_id)
        return node.node_id.binary() if node is not None else None

    def shutdown(self) -> None:
        for pid in list(self._nodes):
            self.terminate_node(pid)
