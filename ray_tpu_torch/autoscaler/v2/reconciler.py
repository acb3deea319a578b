"""Reconciler — one declarative pass: observed state -> instance table
-> provider actions.

Reference: `autoscaler/v2/instance_manager/reconciler.py` (Reconciler.
reconcile: sync cloud-provider state, sync ray-node state, compute
scaling decisions, issue transitions).  Unlike v1's StandardAutoscaler
(imperative in-memory loop), every decision here is a persisted
lifecycle transition, so a crash between any two steps resumes
consistently: REQUESTED instances whose cloud node never appeared are
re-queued, ALLOCATED ones are recognized when the node joins, leaked
cloud nodes are adopted or terminated.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.autoscaler.v2.instance_manager import (
    Instance, InstanceManager, InstanceStatus,
)


class Reconciler:
    def __init__(self, gcs_addr, provider,
                 available_node_types: Dict[str, Dict[str, Any]],
                 max_workers: int = 8, idle_timeout_s: float = 60.0,
                 adopt_untracked: bool = True):
        self._gcs = RpcClient(*tuple(gcs_addr))
        self.provider = provider
        self.node_types = available_node_types
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.adopt_untracked = adopt_untracked
        self.im = InstanceManager(
            kv_get=lambda k: self._gcs.call(
                "kv_get", namespace="autoscaler", key=k, timeout=30),
            kv_put=lambda k, v: self._gcs.call(
                "kv_put", namespace="autoscaler", key=k, value=v,
                timeout=30))
        self._idle_since: Dict[str, float] = {}
        self._missing_since: Dict[str, float] = {}

    # ------------------------------------------------------------ one pass
    def reconcile(self) -> Dict[str, int]:
        stats = {"launched": 0, "terminated": 0, "adopted": 0,
                 "requeued": 0}
        self._sync_cloud(stats)
        self._sync_ray()
        self._scale_up(stats)
        self._scale_down(stats)
        self._launch_queued(stats)
        return stats

    # ----------------------------------------------------- observed state
    def _sync_cloud(self, stats) -> None:
        cloud_ids = set(self.provider.non_terminated_nodes())

        for inst in list(self.im.instances.values()):
            if inst.status == InstanceStatus.REQUESTED:
                # Crash between REQUESTED and recording the cloud id: the
                # node either exists untracked (adopted below) or was
                # never created — requeue so demand is re-evaluated.
                self.im.transition(inst.instance_id,
                                   InstanceStatus.TERMINATED)
                stats["requeued"] += 1
            elif (inst.status in (InstanceStatus.ALLOCATED,
                                  InstanceStatus.RAY_RUNNING,
                                  InstanceStatus.RAY_STOPPING)
                  and inst.cloud_instance_id not in cloud_ids):
                # Cloud node vanished under us (preemption, manual kill).
                self.im.transition(inst.instance_id,
                                   InstanceStatus.TERMINATED)

        # Retry sweep: TERMINATING rows whose terminate call failed on a
        # prior pass (and RAY_STOPPING rows a crash stranded) — re-issue
        # (idempotent) or finish the transition if the node is gone.
        for inst in self.im.with_status(InstanceStatus.RAY_STOPPING):
            self.im.transition(inst.instance_id,
                               InstanceStatus.TERMINATING)
        for inst in self.im.with_status(InstanceStatus.TERMINATING):
            if inst.cloud_instance_id not in cloud_ids:
                self.im.transition(inst.instance_id,
                                   InstanceStatus.TERMINATED)
            else:
                self._terminate(inst, stats)

        tracked = {i.cloud_instance_id for i in self.im.instances.values()
                   if i.cloud_instance_id}
        for cid in cloud_ids - tracked:
            node_type = self.provider.node_type_of(cid) or "unknown"
            if self.adopt_untracked:
                inst = self.im.add(node_type)
                self.im.transition(inst.instance_id,
                                   InstanceStatus.REQUESTED)
                self.im.transition(inst.instance_id,
                                   InstanceStatus.ALLOCATED,
                                   cloud_instance_id=cid)
                stats["adopted"] += 1
            else:
                self.provider.terminate_node(cid)
                stats["terminated"] += 1

    def _sync_ray(self) -> None:
        for inst in self.im.with_status(InstanceStatus.ALLOCATED):
            internal = self.provider.internal_node_id(
                inst.cloud_instance_id)
            if internal is not None:
                self.im.transition(inst.instance_id,
                                   InstanceStatus.RAY_RUNNING,
                                   node_id=internal.hex())

    # ---------------------------------------------------------- decisions
    def _load(self):
        return self._gcs.call("get_cluster_load", timeout=30)

    def _scale_up(self, stats) -> None:
        load = self._load()
        demands = [ResourceSet(d) for n in load
                   for d in n.get("pending_demands", [])]
        if not demands:
            # min_workers floor per type
            counts: Dict[str, int] = {}
            for inst in self.im.active():
                counts[inst.node_type] = counts.get(inst.node_type, 0) + 1
            for name, cfg in self.node_types.items():
                need = cfg.get("min_workers", 0) - counts.get(name, 0)
                for _ in range(max(0, need)):
                    if len(self.im.active()) >= self.max_workers:
                        return
                    self.im.add(name)
            return

        # Pending (not yet RAY_RUNNING) instances will absorb demand.
        pending_types = [i.node_type for i in self.im.active()
                         if i.status != InstanceStatus.RAY_RUNNING]
        for demand in demands:
            if any(ResourceSet(n["available"]).is_superset_of(demand)
                   for n in load):
                continue
            covered = next((t for t in pending_types
                            if self._type_fits(t, demand)), None)
            if covered is not None:
                pending_types.remove(covered)
                continue
            node_type = next((t for t in sorted(self.node_types)
                              if self._type_fits(t, demand)), None)
            if node_type is None:
                continue
            if len(self.im.active()) >= self.max_workers:
                break
            self.im.add(node_type)
            pending_types.append(node_type)

    def _type_fits(self, node_type: str, demand: ResourceSet) -> bool:
        caps = ResourceSet(self.node_types[node_type].get("resources", {}))
        return caps.is_superset_of(demand)

    def _scale_down(self, stats) -> None:
        load = self._load()
        by_internal = {n["node_id"].hex() if isinstance(n["node_id"], bytes)
                       else n["node_id"]: n for n in load}
        now = time.monotonic()
        for inst in self.im.with_status(InstanceStatus.RAY_RUNNING):
            node = by_internal.get(inst.node_id)
            if node is None:
                # Ray process gone but the VM is up (OOM-killed worker):
                # after a grace period, reclaim the node — otherwise it
                # consumes a max_workers slot forever doing nothing.
                since = self._missing_since.setdefault(
                    inst.instance_id, now)
                if now - since >= self.idle_timeout_s:
                    self.im.transition(inst.instance_id,
                                       InstanceStatus.TERMINATING)
                    self._terminate(inst, stats)
                    self._missing_since.pop(inst.instance_id, None)
                continue
            self._missing_since.pop(inst.instance_id, None)
            fully_idle = (node["available"] == node["total"]
                          and not node.get("pending_demands"))
            if not fully_idle:
                self._idle_since.pop(inst.instance_id, None)
                continue
            since = self._idle_since.setdefault(inst.instance_id, now)
            min_of_type = self.node_types.get(inst.node_type, {}).get(
                "min_workers", 0)
            same_type = [i for i in self.im.active()
                         if i.node_type == inst.node_type]
            if (now - since >= self.idle_timeout_s
                    and len(same_type) > min_of_type):
                self.im.transition(inst.instance_id,
                                   InstanceStatus.RAY_STOPPING)
                self.im.transition(inst.instance_id,
                                   InstanceStatus.TERMINATING)
                self._terminate(inst, stats)
                self._idle_since.pop(inst.instance_id, None)

    def _terminate(self, inst: Instance, stats) -> None:
        """TERMINATING -> TERMINATED; a failed cloud call leaves the row
        TERMINATING for the retry sweep in _sync_cloud (never wedged,
        never silently leaked)."""
        try:
            self.provider.terminate_node(inst.cloud_instance_id)
        except Exception:
            return
        self.im.transition(inst.instance_id, InstanceStatus.TERMINATED)
        stats["terminated"] += 1

    # ------------------------------------------------------------ actions
    def _launch_queued(self, stats) -> None:
        for inst in self.im.with_status(InstanceStatus.QUEUED):
            self.im.transition(inst.instance_id, InstanceStatus.REQUESTED)
            try:
                cid = self.provider.create_node(
                    inst.node_type, self.node_types[inst.node_type])
            except Exception:
                self.im.transition(inst.instance_id,
                                   InstanceStatus.ALLOCATION_FAILED)
                continue
            self.im.transition(inst.instance_id, InstanceStatus.ALLOCATED,
                               cloud_instance_id=cid)
            stats["launched"] += 1
