"""WorkerGroup — the fleet of training worker actors: the port's copy of
``ray_tpu/train/_internal/worker_group.py``.

Reference: `train/_internal/worker_group.py:102`. Each worker is a plain
actor hosting (a) an ``execute`` escape hatch for backend setup and (b) the
training session protocol (init/start/poll). A worker that asks for
``GPU`` leases it as ``num_gpus``: the raylet names its card in
``CUDA_VISIBLE_DEVICES``, and ``metadata()`` reports the lease's ids.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._internal.session import (
    TrainContext, _TrainSession,
)
from ray_tpu_torch.train.checkpoint import Checkpoint


@ray_tpu_torch.remote
class TrainWorker:
    def __init__(self, world_rank: int):
        self.world_rank = world_rank
        self.session: Optional[_TrainSession] = None

    # -- generic escape hatch (backends run arbitrary setup through this) ---
    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    # -- metadata -----------------------------------------------------------
    def get_metadata(self) -> Dict[str, Any]:
        ctx = ray_tpu_torch.get_runtime_context()
        return {
            "node_id": ctx.get_node_id(),
            "hostname": socket.gethostname(),
            "ip": os.environ.get("RAY_TPU_NODE_IP", "127.0.0.1"),
            "pid": os.getpid(),
            "gpu_ids": ctx.get_gpu_ids(),
        }

    def find_free_port(self) -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    # -- session protocol ---------------------------------------------------
    def start_session(self, train_fn: Callable, config: Dict[str, Any],
                      context: TrainContext,
                      latest_checkpoint_path: Optional[str]) -> bool:
        ckpt = (Checkpoint(latest_checkpoint_path)
                if latest_checkpoint_path else None)
        self.session = _TrainSession(train_fn, config, context, ckpt)
        self.session.start()
        return True

    def next_result(self):
        """Blocks until the session produces the next report/final event."""
        assert self.session is not None, "session not started"
        item = self.session.next_result(timeout=3600)
        return item

    def shutdown_session(self):
        self.session = None
        return True


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_group=None):
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        self.num_workers = num_workers
        self.workers: List[Any] = []
        for rank in range(num_workers):
            options: Dict[str, Any] = {
                "num_cpus": resources_per_worker.get("CPU", 1),
                "resources": {k: v for k, v in resources_per_worker.items()
                              if k not in ("CPU", "GPU")},
            }
            if resources_per_worker.get("GPU"):
                options["num_gpus"] = resources_per_worker["GPU"]
            if placement_group is not None:
                options["scheduling_strategy"] = \
                    PlacementGroupSchedulingStrategy(
                        placement_group=placement_group,
                        placement_group_bundle_index=rank)
            self.workers.append(TrainWorker.options(**options).remote(rank))

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker, return all results (ordered by rank)."""
        return ray_tpu_torch.get(
            [w.execute.remote(fn, *args, **kwargs) for w in self.workers],
            timeout=600)

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(
            self.workers[rank].execute.remote(fn, *args, **kwargs),
            timeout=600)

    def metadata(self) -> List[Dict[str, Any]]:
        return ray_tpu_torch.get(
            [w.get_metadata.remote() for w in self.workers], timeout=600)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
