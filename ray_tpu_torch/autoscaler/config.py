"""Cluster-launcher YAML config: schema validation + GPU gang expansion.

Reference: `python/ray/autoscaler/ray-schema.json` (the cluster YAML
schema), `autoscaler/_private/util.py:prepare_config/validate_config`.
A node type may declare ``node_config.gpu`` (a card type and a total
count, like ``H100-16``); it expands into per-host resources (``GPU`` and
the ``GPU-<type>`` tag every node of such cards advertises), a gang size
(hosts per gang), and the promoted ``GPU-{type}-{count}-head`` resource on
host 0 of every gang: the scheduling handle that gang-launches the hosts
atomically, as the reference's ``TPU-{type}-head`` does for a pod slice.

Example::

    cluster_name: gpu-demo
    max_workers: 16
    provider:
      type: subprocess      # fake | subprocess | gcp_gpu | kuberay | module path
    available_node_types:
      cpu.head:
        resources: {CPU: 8}
      gpu.h100x16:
        node_config: {gpu: H100-16}   # 2 hosts of 8 cards
        min_workers: 0
        max_workers: 2      # gangs, not hosts
    head_node_type: cpu.head
    idle_timeout_minutes: 1
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

# A host holds at most this many cards (an HGX board); larger counts split
# into hosts of this size unless gpu_hosts / gpus_per_host say otherwise.
MAX_GPUS_PER_HOST = 8

# What a config written for the reference's TPU launcher names, and this
# slice's word for it.
_SLICE = "the autoscaler slice of ray_tpu_torch launches NVIDIA GPU nodes"

_TOP_KEYS = {"cluster_name", "max_workers", "provider",
             "available_node_types", "head_node_type",
             "idle_timeout_minutes", "setup_commands",
             "head_setup_commands", "worker_setup_commands",
             "initialization_commands", "file_mounts", "auth"}

_TYPE_KEYS = {"resources", "min_workers", "max_workers", "node_config",
              "worker_setup_commands", "labels"}


class ClusterConfigError(ValueError):
    pass


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    if not os.path.isfile(path):
        raise ClusterConfigError(f"cluster config {path!r} not found")
    with open(path) as f:
        raw = yaml.safe_load(f)
    return validate_cluster_config(raw)


def validate_cluster_config(cfg: Any) -> Dict[str, Any]:
    if not isinstance(cfg, dict):
        raise ClusterConfigError("cluster config must be a mapping")
    unknown = set(cfg) - _TOP_KEYS
    if unknown:
        raise ClusterConfigError(
            f"unknown top-level config key(s): {sorted(unknown)}; "
            f"known: {sorted(_TOP_KEYS)}")
    if "cluster_name" not in cfg or not isinstance(cfg["cluster_name"], str):
        raise ClusterConfigError("cluster_name (str) is required")
    provider = cfg.get("provider") or {}
    if not isinstance(provider, dict) or "type" not in provider:
        raise ClusterConfigError("provider.type is required")
    if provider["type"] == "gcp_tpu":
        raise ClusterConfigError(
            f"provider type 'gcp_tpu': {_SLICE}; use 'gcp_gpu' (Compute "
            "Engine GPU VMs)")
    types = cfg.get("available_node_types")
    if not isinstance(types, dict) or not types:
        raise ClusterConfigError("available_node_types must be a non-empty "
                                 "mapping of node type name -> spec")
    out = dict(cfg)
    out.setdefault("max_workers", 8)
    out.setdefault("idle_timeout_minutes", 5)
    out["available_node_types"] = {
        name: _expand_node_type(name, spec)
        for name, spec in types.items()
    }
    head = cfg.get("head_node_type")
    if head is not None and head not in types:
        raise ClusterConfigError(
            f"head_node_type {head!r} is not in available_node_types")
    if not isinstance(out["max_workers"], int) or out["max_workers"] < 0:
        raise ClusterConfigError("max_workers must be a non-negative int")
    return out


def _expand_node_type(name: str, spec: Any) -> Dict[str, Any]:
    if not isinstance(spec, dict):
        raise ClusterConfigError(f"node type {name!r} must be a mapping")
    unknown = set(spec) - _TYPE_KEYS
    if unknown:
        raise ClusterConfigError(
            f"node type {name!r}: unknown key(s) {sorted(unknown)}")
    out = dict(spec)
    out.setdefault("min_workers", 0)
    out.setdefault("max_workers", 1)
    out.setdefault("resources", {})
    out.setdefault("node_config", {})
    if not isinstance(out["resources"], dict):
        raise ClusterConfigError(f"node type {name!r}: resources must be "
                                 "a mapping")
    if "tpu" in out["node_config"]:
        raise ClusterConfigError(
            f"node type {name!r}: node_config.tpu: {_SLICE}; declare "
            "node_config.gpu (e.g. H100-8) instead")
    if "TPU" in out["resources"]:
        raise ClusterConfigError(
            f"node type {name!r}: a TPU resource: {_SLICE}; declare GPU "
            "instead")
    gpu = out["node_config"].get("gpu")
    if gpu:
        hosts, per_host = gpu_gang_shape(
            gpu,
            hosts=out["node_config"].get("gpu_hosts"),
            gpus_per_host=out["node_config"].get("gpus_per_host"))
        gpu_type = gpu.rsplit("-", 1)[0]
        res = dict(out["resources"])
        res.setdefault("CPU", out["node_config"].get("cpus_per_host", 8))
        res["GPU"] = per_host
        # The card-type tag the raylet advertises on a node of these cards.
        res[f"GPU-{gpu_type}"] = float(per_host)
        out["resources"] = res
        out["gang_size"] = hosts
        # Host 0 of each gang carries the promoted gang-head resource: a
        # single task demanding {"GPU-H100-16-head": 1} gang-schedules the
        # hosts (each then joins the same torch.distributed world).
        out["head_resources"] = {f"GPU-{gpu}-head": 1}
        out["gpu_type"] = gpu
    else:
        out["gang_size"] = int(out["node_config"].get("gang_size", 1))
    if out["gang_size"] < 1:
        raise ClusterConfigError(f"node type {name!r}: gang_size >= 1")
    return out


def gpu_gang_shape(gpu: str, hosts: Optional[int] = None,
                   gpus_per_host: Optional[int] = None) -> tuple:
    """(hosts_per_gang, gpus_per_host) for ``<type>-<count>``: the
    overrides when given, else one host up to ``MAX_GPUS_PER_HOST`` cards
    and hosts of that many above it."""
    m = re.fullmatch(r"([A-Za-z0-9]+)-([0-9]+)", str(gpu))
    if m is None or int(m.group(2)) < 1:
        raise ClusterConfigError(
            f"unknown GPU shape {gpu!r}: write <type>-<count>, e.g. "
            "H100-8")
    total = int(m.group(2))
    if hosts and gpus_per_host:
        return int(hosts), int(gpus_per_host)
    if hosts or gpus_per_host:
        split = int(hosts or gpus_per_host)
        if split < 1 or total % split:
            raise ClusterConfigError(
                f"GPU shape {gpu!r} does not split into "
                + (f"{split} hosts" if hosts else f"hosts of {split}"))
        return (split, total // split) if hosts else (total // split, split)
    if total <= MAX_GPUS_PER_HOST:
        return 1, total
    if total % MAX_GPUS_PER_HOST:
        raise ClusterConfigError(
            f"GPU shape {gpu!r} does not split into hosts of "
            f"{MAX_GPUS_PER_HOST}; declare gpu_hosts and gpus_per_host "
            "explicitly")
    return total // MAX_GPUS_PER_HOST, MAX_GPUS_PER_HOST


def make_provider(cfg: Dict[str, Any], gcs_addr, session_dir: str):
    """Instantiate the provider named by provider.type."""
    ptype = cfg["provider"]["type"]
    if ptype in ("fake", "subprocess"):
        from ray_tpu_torch.autoscaler.gpu_pod_provider import \
            SubprocessPodProvider

        return SubprocessPodProvider(gcs_addr, session_dir)
    if ptype in ("gcp", "gcp_gpu"):
        from ray_tpu_torch.autoscaler.gcp_gpu_provider import \
            GceGpuPodProvider

        return GceGpuPodProvider(cfg["provider"], gcs_addr)
    if ptype in ("kuberay", "kubernetes", "gke"):
        from ray_tpu_torch.autoscaler.kuberay_provider import KubeRayProvider

        return KubeRayProvider(cfg["provider"], gcs_addr)
    if "." in ptype:  # external: "my.module.MyProvider"
        import importlib

        mod, _, cls = ptype.rpartition(".")
        provider_cls = getattr(importlib.import_module(mod), cls)
        return provider_cls(cfg["provider"], gcs_addr, session_dir)
    raise ClusterConfigError(
        f"unknown provider type {ptype!r}: use 'fake'/'subprocess', "
        "'gcp_gpu', 'kuberay', or a "
        "'module.Class' path")
