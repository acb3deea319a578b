"""Placement groups — gang scheduling of resource bundles.

Reference: `python/ray/util/placement_group.py` + GCS-side 2PC
(`gcs_placement_group_manager.h`, raylet `placement_group_resource_manager.h:54`).

A placement group reserves N resource bundles across the cluster atomically
(STRICT_SPREAD/STRICT_PACK) or best-effort (PACK/SPREAD). Tasks/actors target
a group (optionally a specific bundle) via PlacementGroupSchedulingStrategy.

A bundle's GPUs are reserved when the bundle is: a lease inside the bundle
gets the bundle's own GPU ids (``{"GPU": 1, "CPU": 1}`` per rank of a
data-parallel group, one card each).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass
class PlacementGroup:
    id: bytes
    bundles: List[Dict[str, float]]
    strategy: str = "PACK"
    name: str = ""

    def ready(self) -> "object":
        """Returns an ObjectRef resolving when the PG is created
        (API parity with the reference's `pg.ready()`)."""
        import ray_tpu_torch

        pg_id = self.id

        @ray_tpu_torch.remote
        def _pg_ready_waiter(pg_id_hex: str):
            from ray_tpu_torch._private.worker import global_worker

            reply = global_worker().gcs.call(
                "wait_placement_group_ready",
                pg_id=bytes.fromhex(pg_id_hex), wait_timeout=300.0,
                timeout=310.0)
            if reply.get("state") != "CREATED":
                raise RuntimeError(
                    f"placement group not created: {reply}")
            return True

        return _pg_ready_waiter.remote(pg_id.hex())

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        from ray_tpu_torch._private.worker import global_worker

        reply = global_worker().gcs.call(
            "wait_placement_group_ready", pg_id=self.id,
            wait_timeout=timeout_seconds, timeout=timeout_seconds + 5)
        return reply.get("state") == "CREATED"

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    def bundle_count(self) -> int:
        return len(self.bundles)


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    from ray_tpu_torch._private.ids import PlacementGroupID
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    pg_id = PlacementGroupID.of(w.job_id)
    w.gcs.call("create_placement_group", pg_id=pg_id.binary(),
               bundles=bundles, strategy=strategy, name=name,
               lifetime=lifetime, owner_addr=w.addr)
    return PlacementGroup(pg_id.binary(), bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch._private.worker import global_worker

    global_worker().gcs.call("remove_placement_group", pg_id=pg.id)


def get_placement_group(name: str) -> Optional[PlacementGroup]:
    from ray_tpu_torch._private.worker import global_worker

    for info in global_worker().gcs.call("list_placement_groups"):
        if info and info.get("name") == name and info["state"] != "REMOVED":
            return PlacementGroup(info["pg_id"], info["bundles"],
                                  info["strategy"], info["name"])
    return None


def placement_group_table() -> List[Dict]:
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs.call("list_placement_groups")
