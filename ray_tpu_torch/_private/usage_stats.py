"""Usage stats (reference: `_private/usage/usage_lib.py` +
`dashboard/modules/usage_stats/` — opt-out telemetry pings).

This build is air-gapped by design, so the collector writes the report
locally (session dir `usage_stats.json`) instead of POSTing it; the
schema mirrors the reference's payload (cluster metadata, library usage
tags, counters). Disable with RAY_TPU_USAGE_STATS_ENABLED=0 — the same
opt-out contract as the reference.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Set

_tags: Dict[str, str] = {}
_library_usages: Set[str] = set()


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "False")


def record_library_usage(name: str) -> None:
    """Called by each AI library at import/use time (reference:
    `record_library_usage` in usage_lib)."""
    _library_usages.add(name)


def record_extra_usage_tag(key: str, value: str) -> None:
    _tags[str(key)] = str(value)


def get_library_usages() -> List[str]:
    return sorted(_library_usages)


def generate_report(cluster_metadata: Dict[str, Any]) -> Dict[str, Any]:
    import ray_tpu_torch

    return {
        "schema_version": "0.1",
        "source": "ray_tpu_torch",
        "session_id": cluster_metadata.get("session_id"),
        "collect_timestamp_ms": int(time.time() * 1000),
        "os": sys.platform,
        "python_version": sys.version.split()[0],
        "ray_tpu_version": getattr(ray_tpu_torch, "__version__", "0.0.0"),
        "total_num_nodes": cluster_metadata.get("num_nodes"),
        "total_num_cpus": cluster_metadata.get("num_cpus"),
        "total_num_gpus": cluster_metadata.get("num_gpus"),
        "libraries_used": get_library_usages(),
        "extra_usage_tags": dict(_tags),
    }


def write_report(session_dir: str,
                 cluster_metadata: Dict[str, Any]) -> str | None:
    """Write the local usage report; returns its path (None if opted
    out or unwritable)."""
    if not usage_stats_enabled():
        return None
    try:
        path = os.path.join(session_dir, "usage_stats.json")
        with open(path, "w") as f:
            json.dump(generate_report(cluster_metadata), f, indent=2)
        return path
    except OSError:
        return None
