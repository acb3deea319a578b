"""Backend plugin interface: the port's copy of ``ray_tpu/train/backend.py``
(reference: `train/backend.py` — Backend with
on_start/on_training_start/on_shutdown hooks + BackendConfig)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Distributed-framework setup hooks running against the worker group."""

    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: "WorkerGroup",
                          backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: BackendConfig) -> None:
        pass
