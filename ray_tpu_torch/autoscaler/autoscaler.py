"""StandardAutoscaler — demand-driven scale up, idle-driven scale down.

Reference: `autoscaler/_private/autoscaler.py` (StandardAutoscaler.update
loop) + `resource_demand_scheduler.py` (bin-packs pending demand against
`available_node_types`) + the v2 rewrite's GCS-driven load source
(`gcs_autoscaler_state_manager.h`). Load comes from the GCS
`get_cluster_load` RPC: per-node availability plus lease demands queued
with nowhere to run, and (in the port) actors the GCS holds with no
node to place them on.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rpc import RpcClient


class StandardAutoscaler:
    """One `update()` = one reconcile pass (call it from a monitor loop)."""

    def __init__(self, gcs_addr, provider,
                 available_node_types: Dict[str, Dict[str, Any]],
                 max_workers: int = 8, idle_timeout_s: float = 60.0):
        self._gcs = RpcClient(*tuple(gcs_addr))
        self.provider = provider
        self.node_types = available_node_types
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self._idle_since: Dict[str, float] = {}
        self._launched_at: Dict[str, float] = {}

    # ----------------------------------------------------------------- update
    def update(self) -> Dict[str, int]:
        """Returns {"launched": n, "terminated": n} for observability."""
        load = self._gcs.call("get_cluster_load", timeout=30)
        launched = self._scale_up(load)
        terminated = self._scale_down(load)
        self._enforce_min_workers()
        return {"launched": launched, "terminated": terminated}

    def _pending_demands(self, load) -> List[ResourceSet]:
        out = []
        for node in load:
            for demand in node.get("pending_demands", []):
                out.append(ResourceSet(demand))
        return out

    def _scale_up(self, load) -> int:
        demands = self._pending_demands(load)
        if not demands:
            return 0
        # Demands a pending launch will satisfy don't need another node.
        pending_types = [self.provider.node_type_of(pid)
                         for pid in self.provider.non_terminated_nodes()
                         if self._is_pending(pid, load)]
        launched = 0
        for demand in demands:
            if self._fits_somewhere(demand, load):
                continue  # schedulable once current queues drain
            covered = False
            for t in pending_types:
                if t and self._type_fits(t, demand):
                    pending_types.remove(t)
                    covered = True
                    break
            if covered:
                continue
            node_type = self._pick_type(demand)
            if node_type is None:
                continue  # infeasible on any configured type
            if len(self.provider.non_terminated_nodes()) >= self.max_workers:
                break
            pid = self.provider.create_node(
                node_type, self.node_types[node_type])
            self._launched_at[pid] = time.monotonic()
            pending_types.append(node_type)
            launched += 1
        return launched

    def _is_pending(self, pid: str, load) -> bool:
        internal = self.provider.internal_node_id(pid)
        if internal is None:
            return True
        return not any(n["node_id"] == internal for n in load)

    def _fits_somewhere(self, demand: ResourceSet, load) -> bool:
        return any(ResourceSet(n["available"]).is_superset_of(demand)
                   for n in load)

    def _type_fits(self, node_type: str, demand: ResourceSet) -> bool:
        caps = ResourceSet(self.node_types[node_type].get("resources", {}))
        return caps.is_superset_of(demand)

    def _pick_type(self, demand: ResourceSet) -> Optional[str]:
        for name in sorted(self.node_types):
            if self._type_fits(name, demand):
                return name
        return None

    # ------------------------------------------------------------- scale down
    def _scale_down(self, load) -> int:
        by_internal = {n["node_id"]: n for n in load}
        now = time.monotonic()
        terminated = 0
        for pid in self.provider.non_terminated_nodes():
            internal = self.provider.internal_node_id(pid)
            node = by_internal.get(internal)
            if node is None:
                continue  # still joining
            # Warm pooled workers are not load — full resource availability
            # with nothing queued is idle.
            fully_idle = (node["available"] == node["total"]
                          and not node.get("pending_demands"))
            if not fully_idle:
                self._idle_since.pop(pid, None)
                continue
            since = self._idle_since.setdefault(pid, now)
            min_of_type = self.node_types.get(
                self.provider.node_type_of(pid) or "", {}).get(
                "min_workers", 0)
            same_type = [p for p in self.provider.non_terminated_nodes()
                         if self.provider.node_type_of(p)
                         == self.provider.node_type_of(pid)]
            if (now - since >= self.idle_timeout_s
                    and len(same_type) > min_of_type):
                self.provider.terminate_node(pid)
                self._idle_since.pop(pid, None)
                terminated += 1
        return terminated

    def _enforce_min_workers(self) -> None:
        counts: Dict[str, int] = {}
        for pid in self.provider.non_terminated_nodes():
            t = self.provider.node_type_of(pid)
            counts[t] = counts.get(t, 0) + 1
        for name, cfg in self.node_types.items():
            for _ in range(cfg.get("min_workers", 0) - counts.get(name, 0)):
                if (len(self.provider.non_terminated_nodes())
                        >= self.max_workers):
                    return
                pid = self.provider.create_node(name, cfg)
                self._launched_at[pid] = time.monotonic()
