"""Runtime context (reference: `python/ray/runtime_context.py`)."""

from __future__ import annotations

from typing import Dict, List, Optional


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_node_id(self) -> str:
        return self._worker.node_id.hex()

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        tid = self._worker.current_task_id()
        return tid.hex() if tid else None

    def get_actor_id(self) -> Optional[str]:
        aid = self._worker.current_actor_id()
        return aid.hex() if aid else None

    def get_gpu_ids(self) -> List[int]:
        """GPU ids assigned to the current task/actor by the raylet (the
        ``CUDA_VISIBLE_DEVICES`` it runs under)."""
        return self._worker.current_gpu_ids()

    @property
    def gcs_address(self):
        return self._worker.gcs_addr

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch._private.worker import global_worker

    return RuntimeContext(global_worker())
