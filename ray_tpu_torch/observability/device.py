"""Per-device gauges: device memory in use / capacity and device inventory.

Sampled by the metrics flusher (registered lazily as a flush sampler,
``ray_tpu_torch.util.metrics.register_flush_sampler``), so any process
that touches the observability plane exports its card's view on the
same cadence as its other metrics. Idle device-memory headroom and a
device count that does not match the lease are the first things to
check when a GPU job underperforms.

- ``device_hbm_used_bytes``: the CUDA caching allocator's bytes in use
  (``torch.cuda.memory_allocated``), tagged by device index and name;
- ``device_hbm_total_bytes``: the card's capacity
  (``torch.cuda.mem_get_info``'s total);
- ``device_count``: visible CUDA devices, tagged by name and platform
  ``gpu``.

Deliberately conservative about initialization: sampling NEVER creates a
CUDA context. It reads only a process whose context is already live
(``torch.cuda.is_initialized()``; ``is_available()`` would load the
driver), and only the devices that process already uses, so a head,
proxy or monitor process never maps ``libcuda``.
"""

from __future__ import annotations

import sys
from typing import List

_gauges = None
_registered = False


def _device_gauges():
    global _gauges
    if _gauges is None:
        from ray_tpu_torch.util.metrics import Gauge

        _gauges = {
            "used": Gauge(
                "device_hbm_used_bytes",
                description="Device memory in use (the CUDA caching "
                            "allocator's allocated bytes).",
                tag_keys=("device", "kind")),
            "total": Gauge(
                "device_hbm_total_bytes",
                description="Device memory capacity (torch.cuda."
                            "mem_get_info total bytes).",
                tag_keys=("device", "kind")),
            "count": Gauge(
                "device_count",
                description="Visible devices by kind/platform.",
                tag_keys=("kind", "platform")),
        }
    return _gauges


def _live_devices() -> List[int]:
    """Indices of the CUDA devices this process already holds a context
    on; [] where no context exists (never creates one)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        current = torch.cuda.current_device()
        return [i for i in range(torch.cuda.device_count())
                if i == current or torch.cuda.memory_reserved(i) > 0]
    except Exception:
        return []


def sample_device_metrics() -> int:
    """Set the device gauges from the live CUDA context; returns the
    number of devices sampled (0 when no context exists)."""
    devices = _live_devices()
    if not devices:
        return 0
    import torch

    g = _device_gauges()
    by_kind = {}
    for i in devices:
        kind = torch.cuda.get_device_name(i)
        by_kind[kind] = by_kind.get(kind, 0) + 1
        tags = {"device": str(i), "kind": kind}
        g["used"].set(float(torch.cuda.memory_allocated(i)), tags=tags)
        try:
            _free, total = torch.cuda.mem_get_info(i)
        except Exception:
            continue
        g["total"].set(float(total), tags=tags)
    for kind, n in by_kind.items():
        g["count"].set(float(n), tags={"kind": kind, "platform": "gpu"})
    return len(devices)


def ensure_sampler_registered() -> None:
    """Idempotently hook device sampling into the metrics flusher."""
    global _registered
    if _registered:
        return
    _registered = True
    from ray_tpu_torch.util.metrics import register_flush_sampler

    register_flush_sampler(sample_device_metrics)
