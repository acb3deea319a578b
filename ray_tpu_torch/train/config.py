"""Train/AIR configuration dataclasses: the port's copy of
``ray_tpu/train/config.py``.

Reference: `python/ray/air/config.py` — ScalingConfig (`:101`),
FailureConfig (`:375`), CheckpointConfig (`:425`), RunConfig.
The port schedules NVIDIA cards: ``use_gpu``/``gpus_per_worker`` lease
each worker ``GPU`` (whole or a fraction), as the runtime's ``num_gpus``
does. The reference's ``use_tpu``, ``chips_per_worker`` and ``topology``
raise, as ``num_tpus`` does on ``remote`` and ``serve.deployment``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # The reference's TPU fields, kept only to refuse them by name.
    use_tpu: bool = False
    chips_per_worker: Optional[int] = None
    topology: Optional[str] = None

    def __post_init__(self):
        for name, unset in (("use_tpu", False), ("chips_per_worker", None),
                            ("topology", None)):
            if getattr(self, name) != unset:
                raise ValueError(
                    f"ScalingConfig({name}=...): ray_tpu_torch schedules "
                    f"NVIDIA GPUs; use use_gpu=True and gpus_per_worker "
                    f"instead of use_tpu, chips_per_worker and topology")

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        if self.use_gpu:
            return {"CPU": 1, "GPU": self.gpus_per_worker}
        return {"CPU": 1}

    def bundle(self) -> Dict[str, float]:
        return self.worker_resources()


@dataclass
class FailureConfig:
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    # Local path OR a pyarrow-fs URI (s3://, gs://, file://); with a URI
    # (or an explicit storage_filesystem) the run stages locally and syncs
    # checkpoints to storage (reference: train/_internal/storage.py).
    storage_path: Optional[str] = None
    storage_filesystem: Optional[Any] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1

    def is_remote_storage(self) -> bool:
        from ray_tpu_torch.train.storage import is_uri

        return self.storage_filesystem is not None or is_uri(
            self.storage_path)

    def resolved_storage_path(self) -> str:
        """LOCAL working root: remote storage stages under a local dir
        and syncs up per checkpoint."""
        if self.is_remote_storage():
            import hashlib

            digest = hashlib.md5(
                str(self.storage_path).encode()).hexdigest()[:10]
            return os.path.join(os.path.expanduser("~/ray_tpu_staging"),
                                digest)
        return self.storage_path or os.path.expanduser("~/ray_tpu_results")


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional["Any"]  # ray_tpu_torch.train.Checkpoint
    path: str
    metrics_dataframe: Optional[List[Dict[str, Any]]] = None
    error: Optional[Any] = None  # str or exception
    config: Optional[Dict[str, Any]] = None  # trial config (tune runs)
