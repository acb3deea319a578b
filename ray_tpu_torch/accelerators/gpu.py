"""GPU accelerator manager: NVIDIA cards as a first-class ``GPU`` resource.

The port's counterpart of the reference's ``accelerators/tpu.py``
(``TPUAcceleratorManager``): it detects how many cards the node has and
their type, validates per-task quantities and makes a lease's cards
visible to the process through ``CUDA_VISIBLE_DEVICES``.

Detection order:

1. ``RAY_TPU_FAKE_GPUS`` (tests: fake N cards without hardware; the type
   then comes from ``RAY_TPU_FAKE_GPU_TYPE``, else none),
2. the node process's ``CUDA_VISIBLE_DEVICES`` when it is set (``""``
   means no card),
3. ``nvidia-smi --query-gpu=index,name --format=csv,noheader``,
4. otherwise 0.

Nothing here imports torch or creates a CUDA context: the GCS, the raylet
and the node call it, and a context there would hold card memory for the
life of the cluster. ``nvidia-smi`` runs in a child process.

CUDA reads ``CUDA_VISIBLE_DEVICES`` once, when a process creates its
context. A pooled worker that already holds a context under one device
set therefore cannot serve a GPU lease of another: ``note_lease`` raises
instead of letting the task run on the wrong card or none.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
FAKE_GPUS_ENV = "RAY_TPU_FAKE_GPUS"
FAKE_GPU_TYPE_ENV = "RAY_TPU_FAKE_GPU_TYPE"
NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=index,name",
                    "--format=csv,noheader"]

# Words of a card's marketing name that are not its type.
_NAME_NOISE = ("NVIDIA", "Tesla", "GeForce", "Quadro")


def _nvidia_smi_cards() -> List[Tuple[str, str]]:
    """[(index, name)] from ``nvidia-smi``, or [] where it is missing or
    fails."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    cards = []
    for line in out.stdout.splitlines():
        index, _, name = line.partition(",")
        if index.strip() and name.strip():
            cards.append((index.strip(), name.strip()))
    return cards


def _visible_entries(value: str) -> List[str]:
    return [v.strip() for v in value.split(",") if v.strip()]


def parse_gpu_type(name: str) -> Optional[str]:
    """The card type in its marketing name: ``NVIDIA H100 80GB HBM3`` ->
    ``H100``, ``NVIDIA A100-SXM4-80GB`` -> ``A100``, ``Tesla V100-SXM2-16GB``
    -> ``V100``, ``NVIDIA GeForce RTX 4090`` -> ``RTX4090``."""
    words = [w for w in name.split() if w not in _NAME_NOISE]
    if not words:
        return None
    head = words[0].split("-")[0]
    if head in ("RTX", "TITAN") and len(words) > 1:
        head += words[1].split("-")[0]
    return head if re.fullmatch(r"[A-Za-z0-9]+", head) else None


class GPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        fake = os.environ.get(FAKE_GPUS_ENV)
        if fake is not None:
            return int(fake)
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is not None:
            return len(_visible_entries(visible))
        return len(_nvidia_smi_cards())

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        if os.environ.get(FAKE_GPUS_ENV) is not None:
            return os.environ.get(FAKE_GPU_TYPE_ENV) or None
        cards = _nvidia_smi_cards()
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is not None:
            wanted = set(_visible_entries(visible))
            cards = [c for c in cards if c[0] in wanted]
        types = {parse_gpu_type(name) for _, name in cards}
        types.discard(None)
        # A node of mixed cards advertises no single type.
        return types.pop() if len(types) == 1 else None

    @staticmethod
    def validate_resource_request_quantity(quantity: float
                                           ) -> Tuple[bool, Optional[str]]:
        if quantity < 0:
            return False, f"GPU request must be >= 0, got {quantity}"
        if quantity == int(quantity) or 0 < quantity < 1:
            return True, None
        return (False, f"GPU request must be a whole number of GPUs or a "
                       f"fraction in (0, 1), got {quantity}")

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)

    @staticmethod
    def get_current_node_extra_resources() -> Dict[str, float]:
        """``GPU-<type>`` with the node's card count, so that
        ``accelerator_type="H100"`` lands on a node of H100s."""
        n = GPUAcceleratorManager.get_current_node_num_accelerators()
        gpu_type = GPUAcceleratorManager.get_current_node_accelerator_type()
        if not n or not gpu_type:
            return {}
        return {f"GPU-{gpu_type}": float(n)}


# The device set CUDA read when this process created its context; None
# until a context is seen.
_bound_devices: Optional[str] = None


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")        # no torch loaded: no context
    return torch is not None and bool(torch.cuda.is_initialized())


def note_lease(ids: List[int]) -> None:
    """Make a task's or actor's GPUs (``ids``, possibly none) visible to
    this process, or raise where CUDA already runs here under another
    device set.

    ``CUDA_VISIBLE_DEVICES`` is set before the task body runs, so a worker
    without a context picks up the lease's cards when its task first
    touches CUDA. Once a context exists the variable no longer matters:
    a GPU lease for another set raises ``RuntimeError``; a lease without
    GPUs runs (it asked for no card)."""
    global _bound_devices
    want = ",".join(str(i) for i in ids)
    if _cuda_initialized():
        if _bound_devices is None:
            # The variable changes only here and only while no context
            # exists, so its value is the one the context was made under.
            _bound_devices = os.environ.get(CUDA_VISIBLE_DEVICES_ENV, "")
        if ids and want != _bound_devices:
            raise RuntimeError(
                f"this worker's CUDA context was created with "
                f"CUDA_VISIBLE_DEVICES={_bound_devices!r}; it cannot serve "
                f"a lease of GPUs {want!r}")
        return
    GPUAcceleratorManager.set_current_process_visible_accelerator_ids(
        [str(i) for i in ids])
