"""Trainers: the port's copy of ``ray_tpu/train/trainer.py``.

Reference: `train/base_trainer.py:567` (`BaseTrainer.fit`),
`train/data_parallel_trainer.py` (`DataParallelTrainer`). The port's
`CudaTrainer` = DataParallelTrainer + CudaConfig: worker processes that
each lease their card as ``GPU`` and run the port's one-device or ZeRO
step on it (``train/cuda_backend.py``).

The reference's ``fit()`` runs the trainer as a one-trial Tune experiment;
the port has no Tune yet, so ``fit()`` runs that trial inline, in
``<storage_path>/<name>``, and raises ``TrainingFailedError`` where the
trial would have errored. ``as_trainable()`` (a trainer as a Tune
trainable) and ``datasets=`` (Train's ingestion from ``ray_tpu/data``)
raise, naming the slices that bring them.
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor, TrainingFailedError,
)
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        if datasets:
            raise NotImplementedError(
                "datasets=: Train's ingestion splits each dataset with "
                "ray_tpu/data's streaming_split, which is not ported yet; "
                "it comes with the Data slice (data/iterator.py with it). "
                "Load the data inside train_loop_per_worker meanwhile")
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config or {}
        self._backend_config = backend_config or BackendConfig()
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._resume_checkpoint = resume_from_checkpoint

    # ------------------------------------------------------------------- fit
    def fit(self) -> Result:
        """Run the training as one trial, inline (reference
        `base_trainer.py:567` wraps itself in a one-trial Tuner)."""
        name = self._run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        experiment_dir = os.path.join(
            self._run_config.resolved_storage_path(), name)
        try:
            return self._run_training(experiment_dir)
        except TrainingFailedError:
            raise
        except Exception as e:  # noqa: BLE001
            raise TrainingFailedError(f"{type(e).__name__}: {e}") from e

    def _run_training(self, experiment_dir: str) -> Result:
        """The training orchestration loop (runs inside the trial)."""
        os.makedirs(experiment_dir, exist_ok=True)
        # Remote storage: checkpoints stage locally under experiment_dir
        # and sync to the pyarrow filesystem after each report.
        self._storage = None
        if self._run_config.is_remote_storage():
            from ray_tpu_torch.train.storage import StorageContext

            # Mirror the local staging layout (<name>/...) so a
            # checkpoint's URI is derivable from its staging path.
            rel = os.path.relpath(
                experiment_dir, self._run_config.resolved_storage_path())
            self._storage = StorageContext(
                self._run_config.storage_path or "",
                "/".join(rel.split(os.sep)) if rel != "." else "",
                filesystem=self._run_config.storage_filesystem)
            self._storage.makedirs()

        executor = BackendExecutor(self._backend_config, self._scaling,
                                   self._run_config, experiment_dir)
        failures = 0
        max_failures = self._run_config.failure_config.max_failures
        latest_ckpt_path = (self._resume_checkpoint.path
                            if self._resume_checkpoint else None)
        history: list = []
        checkpoints: list = []  # (score, path) for top-k retention
        last_metrics: Dict[str, Any] = {}
        error: Optional[BaseException] = None

        try:
            # Inside the try: a backend that refuses the gang (on_start)
            # still has its workers torn down.
            executor.start()
            while True:
                try:
                    self._start_and_poll(executor, latest_ckpt_path, history,
                                         checkpoints)
                    break  # finished cleanly
                except (TrainingFailedError, Exception) as e:  # noqa: BLE001
                    if history:
                        last_metrics = history[-1]
                    if checkpoints:
                        latest_ckpt_path = checkpoints[-1][1]
                    failures += 1
                    if max_failures >= 0 and failures > max_failures:
                        error = e
                        break
                    executor.restart()
        finally:
            executor.shutdown()

        if history:
            last_metrics = history[-1]
        latest = None
        if checkpoints:
            local = checkpoints[-1][1]
            latest = Checkpoint(local)
            if self._storage is not None:
                latest.uri = self._storage.uri_for(os.path.basename(local))
                latest._fs = self._storage.fs
        elif latest_ckpt_path:
            latest = Checkpoint(latest_ckpt_path)
        if error is not None:
            raise TrainingFailedError(
                f"training failed after {failures} failure(s); "
                f"last metrics {last_metrics}: {error}") from error
        return Result(metrics=last_metrics, checkpoint=latest,
                      path=experiment_dir, metrics_dataframe=history)

    def _start_and_poll(self, executor: BackendExecutor,
                        latest_ckpt_path: Optional[str], history: list,
                        checkpoints: list) -> None:
        config = dict(self._config)
        executor.start_training(self._train_fn, config, latest_ckpt_path)
        ckpt_cfg = self._run_config.checkpoint_config
        while True:
            results = executor.get_next_results()
            if results is None:
                return
            reports = {rank: (metrics, ckpt)
                       for rank, metrics, ckpt in results}
            if not reports:
                continue
            # Rank 0's metrics are authoritative (reference semantics).
            rank0 = min(reports)
            metrics, _ = reports[rank0]
            if metrics is not None:
                metrics = dict(metrics)
                metrics.setdefault("training_iteration", len(history) + 1)
                metrics["timestamp"] = time.time()
                history.append(metrics)
            for rank, (_, ckpt_path) in sorted(reports.items()):
                if ckpt_path is not None:
                    score = None
                    if ckpt_cfg.checkpoint_score_attribute and metrics:
                        score = metrics.get(
                            ckpt_cfg.checkpoint_score_attribute)
                    checkpoints.append((score, ckpt_path))
                    if self._storage is not None:
                        self._storage.upload_dir(
                            ckpt_path, os.path.basename(ckpt_path))
            self._enforce_keep_k(checkpoints)

    def _enforce_keep_k(self, checkpoints: list) -> None:
        keep = self._run_config.checkpoint_config.num_to_keep
        if keep is None or len(checkpoints) <= keep:
            return
        attr = self._run_config.checkpoint_config.checkpoint_score_attribute
        if attr:
            order = self._run_config.checkpoint_config.checkpoint_score_order
            ranked = sorted(
                checkpoints,
                key=lambda sc: (sc[0] is None,
                                -sc[0] if order == "max" and sc[0] is not None
                                else sc[0] if sc[0] is not None else 0))
            doomed = ranked[keep:]
        else:
            doomed = checkpoints[:-keep]
        for item in doomed:
            if item in checkpoints and len(checkpoints) > keep:
                checkpoints.remove(item)
                # A path may legitimately appear under several retention
                # entries; only delete from disk once no kept entry
                # references it.
                if all(path != item[1] for _, path in checkpoints):
                    shutil.rmtree(item[1], ignore_errors=True)
                    if getattr(self, "_storage", None) is not None:
                        self._storage.delete(os.path.basename(item[1]))

    def as_trainable(self):
        """The reference wraps a trainer into a Tune trainable here
        (`base_trainer.py:724`). The port has no Tune yet."""
        raise NotImplementedError(
            "as_trainable(): a trainer as a Tune trainable needs ray_tpu/"
            "tune, which is not ported yet; it comes with the Tune slice. "
            "Call fit() to run the training as one trial")


class CudaTrainer(DataParallelTrainer):
    """The port's trainer, the counterpart of the reference's
    `JaxTrainer`.

    Usage::

        from ray_tpu_torch.train.cuda_backend import pod_train_loop

        trainer = CudaTrainer(
            pod_train_loop,
            train_loop_config={"model_config": cfg, "steps": 3},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            cuda_config=CudaConfig(weight_update="sharded",
                                   mesh_axes={"data": 4}),
        )
        result = trainer.fit()

    On a host without a card, ``ScalingConfig(num_workers=n)`` and
    ``CudaConfig(device="cpu")`` run the same loop on CPU workers.
    """

    def __init__(self, train_loop_per_worker: Callable, *,
                 cuda_config: Optional["Any"] = None, **kwargs):
        from ray_tpu_torch.train.cuda_backend import CudaConfig

        backend_config = cuda_config or CudaConfig()
        super().__init__(train_loop_per_worker,
                         backend_config=backend_config, **kwargs)


class TorchTrainer(DataParallelTrainer):
    """CPU-torch data-parallel trainer over the same worker-group
    machinery as CudaTrainer (reference: `train/torch/torch_trainer.py`;
    gloo process groups, see `train/torch_backend.py`).

    Usage::

        def train_loop(config):
            import torch.distributed as dist
            model = torch.nn.parallel.DistributedDataParallel(model)
            ...ray_tpu_torch.train.report(...) per epoch...

        TorchTrainer(train_loop,
                     scaling_config=ScalingConfig(num_workers=2)).fit()
    """

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional["Any"] = None, **kwargs):
        from ray_tpu_torch.train.torch_backend import TorchConfig

        backend_config = torch_config or TorchConfig()
        super().__init__(train_loop_per_worker,
                         backend_config=backend_config, **kwargs)
