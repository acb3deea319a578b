"""Resource model: fixed-point resource arithmetic over named resources.

Mirrors the reference's scheduling substrate (`scheduling_ids.h:35`
`PredefinedResourcesEnum`, `fixed_point.h`, `cluster_resource_data.h`) with the
GPU a predefined resource: {CPU, MEM, GPU, OBJECT_STORE_MEM} plus arbitrary
custom string resources (e.g. ``GPU-H100``, the card type a node advertises).

All quantities are fixed-point with 1/10000 granularity so that fractional
requests (num_cpus=0.5) compose without float drift — the same trick as the
reference's `FixedPoint`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

RESOLUTION = 10_000

CPU = "CPU"
MEM = "memory"
GPU = "GPU"
OBJECT_STORE_MEM = "object_store_memory"

PREDEFINED = (CPU, MEM, GPU, OBJECT_STORE_MEM)

# Custom resource implicitly attached to GPU nodes (see accelerators/gpu.py):
# "GPU-<type>" (e.g. GPU-H100), which ``accelerator_type="H100"`` demands.


def to_fixed(value: float) -> int:
    return round(value * RESOLUTION)


def from_fixed(value: int) -> float:
    return value / RESOLUTION


class ResourceSet:
    """Immutable-ish map of resource name -> fixed-point quantity.

    Zero-valued entries are dropped, so an empty set means "no resources".
    """

    __slots__ = ("_fixed",)

    def __init__(self, quantities: Mapping[str, float] | None = None, *, _fixed=None):
        if _fixed is not None:
            self._fixed: Dict[str, int] = {k: v for k, v in _fixed.items() if v != 0}
        else:
            self._fixed = {
                name: to_fixed(qty)
                for name, qty in (quantities or {}).items()
                if to_fixed(qty) != 0
            }

    # -- accessors ----------------------------------------------------------
    def get(self, name: str) -> float:
        return from_fixed(self._fixed.get(name, 0))

    def get_fixed(self, name: str) -> int:
        return self._fixed.get(name, 0)

    def names(self) -> Iterable[str]:
        return self._fixed.keys()

    def is_empty(self) -> bool:
        return not self._fixed

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._fixed.items()}

    # -- arithmetic ---------------------------------------------------------
    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._fixed)
        for k, v in other._fixed.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet(_fixed=out)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._fixed)
        for k, v in other._fixed.items():
            out[k] = out.get(k, 0) - v
        return ResourceSet(_fixed=out)

    def is_superset_of(self, demand: "ResourceSet") -> bool:
        return all(self._fixed.get(k, 0) >= v for k, v in demand._fixed.items())

    def has_negative(self) -> bool:
        return any(v < 0 for v in self._fixed.values())

    # -- comparison / misc --------------------------------------------------
    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._fixed == other._fixed

    def __hash__(self):
        return hash(frozenset(self._fixed.items()))

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __reduce__(self):
        return (_resource_set_from_fixed, (dict(self._fixed),))


def _resource_set_from_fixed(fixed):
    return ResourceSet(_fixed=fixed)


def pg_task_demand(demand: "ResourceSet", pg_hex: str,
                   bundle_index: int) -> "ResourceSet":
    """Rewrite a task's demand onto placement-group bundle-formatted
    resources (reference scheme: tasks inside a PG consume
    ``{name}_group_{index}_{pg_id}`` / ``{name}_group_{pg_id}``).

    Single source of truth for the formatted-resource naming — used by both
    the owner-side submitter and the GCS actor scheduler.
    """
    out = {}
    for name, qty in demand.to_dict().items():
        if bundle_index >= 0:
            out[f"{name}_group_{bundle_index}_{pg_hex}"] = qty
        else:
            out[f"{name}_group_{pg_hex}"] = qty
    if not out:
        # Zero-resource tasks still anchor to the PG's wildcard resource.
        out[f"bundle_group_{pg_hex}"] = 0.001
    return ResourceSet(out)


def pg_bundle_grant(bundle_resources: "ResourceSet", pg_hex: str,
                    bundle_index: int) -> "ResourceSet":
    """The formatted resources a raylet mints when committing a bundle."""
    out = {}
    for name, qty in bundle_resources.to_dict().items():
        out[f"{name}_group_{bundle_index}_{pg_hex}"] = qty
        out[f"{name}_group_{pg_hex}"] = qty
    out[f"bundle_group_{bundle_index}_{pg_hex}"] = 1000
    out[f"bundle_group_{pg_hex}"] = 1000
    return ResourceSet(out)


class NodeResources:
    """A node's total and available resources plus labels.

    Utilization math backs the hybrid scheduling policy (reference:
    `hybrid_scheduling_policy.h:29-48`): the *critical resource utilization*
    of a node is max over resources of used/total.
    """

    def __init__(self, total: ResourceSet, labels: Dict[str, str] | None = None):
        self.total = total
        self.available = total
        self.labels = labels or {}

    def try_allocate(self, demand: ResourceSet) -> bool:
        if not self.available.is_superset_of(demand):
            return False
        self.available = self.available.subtract(demand)
        return True

    def release(self, demand: ResourceSet) -> None:
        self.available = self.available.add(demand)
        # Guard against double-release pushing past total.
        for name in list(self.available.names()):
            if self.available.get_fixed(name) > self.total.get_fixed(name):
                fixed = dict(self.available._fixed)
                fixed[name] = self.total.get_fixed(name)
                self.available = ResourceSet(_fixed=fixed)

    def is_feasible(self, demand: ResourceSet) -> bool:
        """Could this node EVER run the demand (ignoring current usage)?"""
        return self.total.is_superset_of(demand)

    def critical_utilization(self) -> float:
        best = 0.0
        for name in self.total.names():
            total = self.total.get_fixed(name)
            if total <= 0 or name == OBJECT_STORE_MEM:
                continue
            used = total - self.available.get_fixed(name)
            best = max(best, used / total)
        return best

    def to_dict(self):
        return {
            "total": self.total.to_dict(),
            "available": self.available.to_dict(),
            "labels": dict(self.labels),
        }

    @classmethod
    def from_dict(cls, d) -> "NodeResources":
        nr = cls(ResourceSet(d["total"]), d.get("labels"))
        nr.available = ResourceSet(d["available"])
        return nr
