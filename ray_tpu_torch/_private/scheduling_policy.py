"""Cluster scheduling policies over a replicated resource view.

Role-equivalent to the reference's raylet scheduling data plane
(`scheduling/cluster_resource_scheduler.h`, `policy/hybrid_scheduling_policy.h:29-48`,
spread/node-affinity/node-label/bundle policies). Every raylet (and the GCS,
for actors) holds a `ClusterView` — node_id -> NodeResources — kept in sync by
heartbeat reports, and picks nodes with these pure policies.

Hybrid policy (the default): prefer the local node while its critical resource
utilization is below a threshold; otherwise rank the top-k feasible nodes by
(utilization, node_id) and pick the best — packing at low load, spreading at
high load, deterministic tie-breaks.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.resources import NodeResources, ResourceSet
from ray_tpu_torch._private.task_spec import SchedulingStrategySpec


class ClusterView:
    """node_id(bytes) -> NodeResources, plus liveness."""

    def __init__(self):
        self.nodes: Dict[bytes, NodeResources] = {}

    def update_node(self, node_id: bytes, resources: NodeResources) -> None:
        self.nodes[node_id] = resources

    def remove_node(self, node_id: bytes) -> None:
        self.nodes.pop(node_id, None)

    def get(self, node_id: bytes) -> Optional[NodeResources]:
        return self.nodes.get(node_id)


def pick_node(
    view: ClusterView,
    demand: ResourceSet,
    strategy: SchedulingStrategySpec,
    local_node_id: Optional[bytes],
    pg_bundle_resources: Optional[ResourceSet] = None,
) -> Optional[bytes]:
    """Returns the chosen node id, or None if no feasible node exists now.

    ``pg_bundle_resources`` replaces ``demand`` when a placement-group
    strategy rewired the demand onto bundle-formatted resources.
    """
    if pg_bundle_resources is not None:
        demand = pg_bundle_resources

    if strategy.kind == "NODE_AFFINITY":
        node = view.get(strategy.node_id)
        if node is not None and node.available.is_superset_of(demand):
            return strategy.node_id
        if strategy.soft:
            return _hybrid(view, demand, local_node_id)
        # Hard affinity: only that node will do; schedulable later if feasible.
        if node is not None and node.is_feasible(demand):
            return None
        return None

    if strategy.kind == "NODE_LABEL":
        candidates = _label_filter(view, strategy.hard_labels)
        # Soft labels only narrow preference WITHIN the hard candidate set.
        if strategy.soft_labels:
            preferred = [n for n in candidates
                         if n in set(_label_filter(view, strategy.soft_labels))]
        else:
            preferred = []
        pool = [n for n in (preferred or candidates)
                if view.nodes[n].available.is_superset_of(demand)]
        if not pool:
            pool = [n for n in candidates
                    if view.nodes[n].available.is_superset_of(demand)]
        return min(pool) if pool else None

    if strategy.kind == "SPREAD":
        return _spread(view, demand)

    return _hybrid(view, demand, local_node_id)


def _label_filter(view: ClusterView, labels: Dict[str, List[str]]) -> List[bytes]:
    out = []
    for node_id, node in view.nodes.items():
        ok = True
        for key, values in labels.items():
            if node.labels.get(key) not in values:
                ok = False
                break
        if ok:
            out.append(node_id)
    return out


def _hybrid(view: ClusterView, demand: ResourceSet,
            local_node_id: Optional[bytes]) -> Optional[bytes]:
    threshold = GlobalConfig.scheduler_spread_threshold
    local = view.get(local_node_id) if local_node_id else None
    if (local is not None and local.available.is_superset_of(demand)
            and local.critical_utilization() < threshold):
        return local_node_id

    feasible = [
        (node.critical_utilization(), node_id)
        for node_id, node in view.nodes.items()
        if node.available.is_superset_of(demand)
    ]
    if not feasible:
        return None
    feasible.sort()
    k = max(1, int(len(view.nodes) * GlobalConfig.scheduler_top_k_fraction))
    util, _ = feasible[0]
    if util < threshold:
        # Pack: lowest utilization, deterministic tie-break.
        return feasible[0][1]
    # Spread regime: random choice among top-k to avoid herd behavior.
    return random.choice(feasible[:k])[1]


def _spread(view: ClusterView, demand: ResourceSet) -> Optional[bytes]:
    feasible = [
        (node.critical_utilization(), node_id)
        for node_id, node in view.nodes.items()
        if node.available.is_superset_of(demand)
    ]
    if not feasible:
        return None
    feasible.sort()
    return feasible[0][1]


def is_feasible_anywhere(view: ClusterView, demand: ResourceSet) -> bool:
    return any(node.is_feasible(demand) for node in view.nodes.values())
