"""Device peak-performance table: the denominator of MFU/MBU.

The program plane (observability/xla.py) turns a tracked program's
counted FLOPs and bytes into *utilization* only by dividing achieved
FLOP/s and bytes/s by what the device could do. This module is the one
place those peaks live:

    spec = lookup("NVIDIA H100 80GB HBM3")
    mfu  = achieved_flops_per_s / spec.peak_flops

Published peaks (bf16 dense matmul FLOP/s and HBM bandwidth):

    ===========  ==============  =============
    device       peak FLOP/s     HBM bytes/s
    ===========  ==============  =============
    H100 SXM     989e12          3.35e12
    TPU v4       275e12          1228e9
    TPU v5e      197e12           819e9
    TPU v5p      459e12          2765e9
    ===========  ==============  =============

The TPU rows are the reference's, kept so a row written by a TPU process
still resolves; the port's rows carry ``spec="h100"``.

Rules of the table:

- ``lookup`` normalizes the strings ``torch.cuda.get_device_name``
  reports ("NVIDIA H100 80GB HBM3" -> h100) and the TPU ``device_kind``
  strings ("TPU v5 lite" -> v5e, "TPU v5p"/"TPU v5" -> v5p, ...).
- CPU processes resolve to a *nominal* spec tagged
  ``measurement="cpu"``: the plumbing (rows, ratios, summaries) works
  identically in CPU tests, but every consumer can see the ratios prove
  wiring, not performance.
- Unknown kinds degrade to ``spec="unknown"`` with **no** peaks
  (``peak_flops is None``): MFU/MBU for such rows is ``None``, never a
  number from a guessed denominator.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ChipSpec:
    """Peak envelope of one device generation.

    ``peak_flops``/``peak_hbm_bytes_per_s`` are per-device bf16 dense
    peaks; ``None`` means the kind is unknown and no utilization ratio
    may be derived from this spec. ``measurement`` tags how rows built
    against this spec should be read: "gpu" (a roofline on the card),
    "tpu" (a TPU's roofline), "cpu" (plumbing proof only), or "unknown".
    """

    spec: str
    peak_flops: Optional[float]
    peak_hbm_bytes_per_s: Optional[float]
    measurement: str = "tpu"

    @property
    def known(self) -> bool:
        return self.peak_flops is not None


# Canonical spec rows, keyed by the normalized generation name.
_SPECS = {
    # H100 SXM5: 989.4 TFLOP/s of dense bf16 on the tensor cores and
    # 3.35 TB/s of HBM3, NVIDIA's published figures.
    "h100": ChipSpec("h100", 989e12, 3.35e12, measurement="gpu"),
    "v4": ChipSpec("v4", 275e12, 1228e9),
    "v5e": ChipSpec("v5e", 197e12, 819e9),
    "v5p": ChipSpec("v5p", 459e12, 2765e9),
    # Nominal CPU envelope: a modern server core's ~100 GFLOP/s and
    # ~100 GB/s memory stream. The numbers only exist so CPU tests
    # exercise the full MFU/MBU path; the "cpu" tag marks every derived
    # ratio as a plumbing proof, not a performance claim.
    "cpu": ChipSpec("cpu", 100e9, 100e9, measurement="cpu"),
}

UNKNOWN = ChipSpec("unknown", None, None, measurement="unknown")

# Device-name substrings -> canonical generation, checked in order (first
# match wins, so "v5 lite"/"v5e" must precede the bare "v5" that v5p
# hosts sometimes report).
_KIND_PATTERNS = (
    ("h100", "h100"),
    ("v5 lite", "v5e"),
    ("v5litepod", "v5e"),
    ("v5e", "v5e"),
    ("v5p", "v5p"),
    ("v5", "v5p"),
    ("v4", "v4"),
    ("cpu", "cpu"),
)


def lookup(device_kind: Optional[str]) -> ChipSpec:
    """Resolve a device name (``torch.cuda.get_device_name``, a TPU
    ``device_kind`` or a spec name) to its :class:`ChipSpec`. Unknown
    kinds return :data:`UNKNOWN` rather than fabricating peaks."""
    if not device_kind:
        return UNKNOWN
    kind = str(device_kind).strip().lower()
    for pattern, gen in _KIND_PATTERNS:
        if pattern in kind:
            return _SPECS[gen]
    return UNKNOWN


def local_spec() -> ChipSpec:
    """Spec of this process's torch device: the card's row where this
    process holds a CUDA context, the nominal CPU row otherwise. Never
    creates a context (``torch.cuda.is_initialized``, not
    ``is_available``, which loads the driver)."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return _SPECS["cpu"]
        return lookup(torch.cuda.get_device_name(torch.cuda.current_device()))
    except Exception:
        return UNKNOWN


def spec_for_device(device) -> ChipSpec:
    """Spec of the device a program ran on (a ``torch.device`` or its
    string): the card's row for a CUDA device, the nominal CPU row for
    the CPU, :data:`UNKNOWN` for anything else."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    if kind == "cpu":
        return _SPECS["cpu"]
    if kind != "cuda":
        return UNKNOWN
    try:
        import torch

        return lookup(torch.cuda.get_device_name(device))
    except Exception:
        return UNKNOWN
