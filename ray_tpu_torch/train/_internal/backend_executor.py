"""BackendExecutor — owns the worker group + backend lifecycle: the port's
copy of ``ray_tpu/train/_internal/backend_executor.py``.

Reference: `train/_internal/backend_executor.py:65,121,427,690`: create a
placement group, start the WorkerGroup inside it, run backend hooks, fan the
training function out, poll per-round results, and restart the whole group
from the latest checkpoint on worker failure. The reference's pod-slice
gang (``ScalingConfig.topology``) has no counterpart: ``ScalingConfig``
refuses it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.train._internal.session import (
    ERRORED, FINISHED, TrainContext,
)
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.util.placement_group import (
    placement_group, remove_placement_group,
)


class TrainingFailedError(exc.RayTpuError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig, run_config: RunConfig,
                 experiment_dir: str):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._run_config = run_config
        self._experiment_dir = experiment_dir
        self.worker_group: Optional[WorkerGroup] = None
        self._pg = None
        self._finished: List[bool] = []

    # ------------------------------------------------------------------ start
    def start(self) -> None:
        n = self._scaling.num_workers
        if n > 1:
            self._pg = placement_group(
                [self._scaling.bundle() for _ in range(n)],
                strategy=self._scaling.placement_strategy)
        if self._pg is not None and not self._pg.wait(120):
            raise TrainingFailedError(
                f"placement group for {n} workers with bundles "
                f"{self._scaling.bundle()} could not be scheduled")
        self.worker_group = WorkerGroup(n, self._scaling.worker_resources(),
                                        self._pg)
        self._backend.on_start(self.worker_group, self._backend_config)

    # --------------------------------------------------------------- training
    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       latest_checkpoint_path: Optional[str]) -> None:
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        n = self.worker_group.num_workers
        node_ids = [m["node_id"] for m in self.worker_group.metadata()]
        local_ranks: Dict[str, int] = {}
        contexts = []
        node_rank_map: Dict[str, int] = {}
        for rank in range(n):
            node = node_ids[rank]
            local_rank = local_ranks.get(node, 0)
            local_ranks[node] = local_rank + 1
            if node not in node_rank_map:
                node_rank_map[node] = len(node_rank_map)
            contexts.append(TrainContext(
                world_rank=rank, world_size=n, local_rank=local_rank,
                local_world_size=0, node_rank=node_rank_map[node],
                experiment_name=os.path.basename(self._experiment_dir),
                storage_dir=self._experiment_dir))
        for ctx in contexts:
            ctx.local_world_size = local_ranks[node_ids[ctx.world_rank]]
        ray_tpu_torch.get([
            w.start_session.remote(train_fn, config, contexts[rank],
                                   latest_checkpoint_path)
            for rank, w in enumerate(self.worker_group.workers)
        ], timeout=600)
        self._finished = [False] * n

    def get_next_results(self, timeout: float = 3600.0
                         ) -> Optional[List[tuple]]:
        """One lockstep round: every unfinished worker's next event.
        Returns None when all workers have finished. Raises on worker crash
        or training-function error."""
        if all(self._finished):
            return None
        refs = [
            w.next_result.remote()
            for w, done in zip(self.worker_group.workers, self._finished)
            if not done
        ]
        # raises on actor death
        items = ray_tpu_torch.get(refs, timeout=timeout)
        results = []
        idx = 0
        for rank in range(self.worker_group.num_workers):
            if self._finished[rank]:
                continue
            kind, payload, ckpt = items[idx]
            idx += 1
            if kind == ERRORED:
                raise TrainingFailedError(
                    f"training function failed on worker {rank}:\n{payload}")
            if kind == FINISHED:
                self._finished[rank] = True
            else:
                results.append((rank, payload, ckpt))
        if not results and all(self._finished):
            return None
        return results

    # ---------------------------------------------------------------- restart
    def restart(self) -> None:
        """Tear down and rebuild the gang (reference `_restart` at
        backend_executor.py:690): a dead worker leaves its peers blocked
        in collectives with it, so the executor kills and re-creates ALL
        workers, then training resumes from the latest checkpoint."""
        self.shutdown(remove_pg=False)
        self.worker_group = WorkerGroup(
            self._scaling.num_workers, self._scaling.worker_resources(),
            self._pg)
        self._backend.on_start(self.worker_group, self._backend_config)

    def shutdown(self, remove_pg: bool = True) -> None:
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if remove_pg and self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
