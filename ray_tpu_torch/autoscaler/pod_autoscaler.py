"""Gang-aware autoscaler: scales GPU gangs (node groups) atomically.

Reference: `autoscaler/_private/autoscaler.py` +
`resource_demand_scheduler.py`, with the unit of scaling changed from a
node to a *node group* (a gang of GPU hosts): demand that needs a gang
launches every host of one atomically; scale-down retires a gang only
when every host has been idle past the timeout. Built from a validated
cluster YAML (`ray_tpu_torch.autoscaler.config`), it is what
`python -m ray_tpu_torch up` runs on the head.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.resources import ResourceSet
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.autoscaler.gpu_pod_provider import PodGroupProvider


class PodAutoscaler:
    """One `update()` = one reconcile pass over groups."""

    def __init__(self, gcs_addr, provider: PodGroupProvider,
                 config: Dict[str, Any]):
        self._gcs = RpcClient(*tuple(gcs_addr))
        self.provider = provider
        self.config = config
        self.node_types = config["available_node_types"]
        self.max_hosts = config.get("max_workers", 8)
        self.idle_timeout_s = config.get("idle_timeout_minutes", 5) * 60.0
        self._group_idle_since: Dict[str, float] = {}

    # ------------------------------------------------------------------ update
    def update(self) -> Dict[str, int]:
        load = self._gcs.call("get_cluster_load", timeout=30)
        launched = self._scale_up(load)
        terminated = self._scale_down(load)
        self._enforce_min_groups()
        return {"launched": launched, "terminated": terminated}

    # ---------------------------------------------------------------- scale up
    def _host0_capacity(self, spec: Dict[str, Any]) -> ResourceSet:
        res = dict(spec.get("resources", {}))
        res.update(spec.get("head_resources", {}))
        return ResourceSet(res)

    def _type_fits(self, name: str, demand: ResourceSet) -> bool:
        return self._host0_capacity(self.node_types[name]).is_superset_of(
            demand)

    def _pick_type(self, demand: ResourceSet) -> Optional[str]:
        # Prefer the smallest gang that satisfies the demand.
        fitting = [n for n in self.node_types if self._type_fits(n, demand)]
        return min(fitting, default=None,
                   key=lambda n: (self.node_types[n]["gang_size"], n))

    def _groups_of_type(self, name: str) -> List[str]:
        return [g for g in self.provider.node_groups()
                if self.provider.group_type_of(g) == name]

    def _joined(self, load, group_id: str) -> bool:
        """Every host of the group has registered with the GCS."""
        live = {n["node_id"] for n in load}
        pids = self.provider.group_nodes(group_id)
        return bool(pids) and all(
            self.provider.internal_node_id(p) in live for p in pids)

    def _scale_up(self, load) -> int:
        demands = []
        for node in load:
            for demand in node.get("pending_demands", []):
                demands.append(ResourceSet(demand))
        if not demands:
            return 0
        # Capacity still joining covers demand without a new launch.
        pending_caps = [
            self._host0_capacity(self.node_types[t])
            for t in (self.provider.group_type_of(g)
                      for g in self.provider.node_groups()
                      if not self._joined(load, g))
            if t in self.node_types
        ]
        launched = 0
        for demand in demands:
            if any(ResourceSet(n["available"]).is_superset_of(demand)
                   for n in load):
                continue
            hit = next((i for i, cap in enumerate(pending_caps)
                        if cap.is_superset_of(demand)), None)
            if hit is not None:
                pending_caps.pop(hit)
                continue
            name = self._pick_type(demand)
            if name is None:
                continue
            spec = self.node_types[name]
            if (len(self._groups_of_type(name)) >= spec["max_workers"]
                    or len(self.provider.non_terminated_nodes())
                    + spec["gang_size"] > self.max_hosts):
                continue
            self.provider.create_node_group(name, spec, spec["gang_size"])
            pending_caps.append(self._host0_capacity(spec))
            launched += 1
        return launched

    # -------------------------------------------------------------- scale down
    def _scale_down(self, load) -> int:
        by_internal = {n["node_id"]: n for n in load}
        now = time.monotonic()
        terminated = 0
        for gid in self.provider.node_groups():
            name = self.provider.group_type_of(gid)
            spec = self.node_types.get(name)
            if spec is None:
                continue
            members = [by_internal.get(self.provider.internal_node_id(p))
                       for p in self.provider.group_nodes(gid)]
            if any(m is None for m in members):
                continue  # still joining
            all_idle = all(m["available"] == m["total"]
                           and not m.get("pending_demands")
                           for m in members)
            if not all_idle:
                self._group_idle_since.pop(gid, None)
                continue
            since = self._group_idle_since.setdefault(gid, now)
            if (now - since >= self.idle_timeout_s
                    and len(self._groups_of_type(name))
                    > spec.get("min_workers", 0)):
                self.provider.terminate_node_group(gid)
                self._group_idle_since.pop(gid, None)
                terminated += 1
        return terminated

    def _enforce_min_groups(self) -> None:
        for name, spec in self.node_types.items():
            short = spec.get("min_workers", 0) - len(
                self._groups_of_type(name))
            for _ in range(max(0, short)):
                if (len(self.provider.non_terminated_nodes())
                        + spec["gang_size"] > self.max_hosts):
                    return
                self.provider.create_node_group(name, spec,
                                                spec["gang_size"])


def run_monitor_loop(gcs_addr, config: Dict[str, Any],
                     session_dir: str, interval_s: float = 5.0,
                     stop_check=None) -> None:
    """The `python -m ray_tpu_torch up` monitor: reconcile until
    stopped. A pass that launches or terminates prints one line with its
    wall-clock time; a pass that fails prints its error and the loop goes
    on."""
    import sys
    import traceback

    from ray_tpu_torch.autoscaler.config import make_provider

    provider = make_provider(config, gcs_addr, session_dir)
    scaler = PodAutoscaler(gcs_addr, provider, config)
    try:
        while stop_check is None or not stop_check():
            try:
                out = scaler.update()
                if out["launched"] or out["terminated"]:
                    print(f"autoscaler: launched {out['launched']} "
                          f"terminated {out['terminated']} at "
                          f"{time.time():.3f}", flush=True)
            except Exception:
                print("autoscaler: update failed:", file=sys.stderr)
                traceback.print_exc()
                sys.stderr.flush()
            time.sleep(interval_s)
    finally:
        provider.shutdown()
