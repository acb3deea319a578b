"""TorchBackend — torch.distributed process groups for CPU-side torch
training: the port's copy of ``ray_tpu/train/torch_backend.py``
(reference: `train/torch/config.py:146` — pick nccl vs gloo, broadcast
rank-0 address, `dist.init_process_group` at `:108`).

The port's accelerator path is ``CudaBackend`` (``train/cuda_backend.py``);
this backend serves CPU-tensor workloads and keeps the reference's
pluggable-Backend story intact: the SAME BackendExecutor/WorkerGroup
machinery boots either, only the rendezvous hook differs. Only gloo is
supported, as in the reference (`torch_backend.py:68-71`): the port moves
tensors between ranks with its own ring kernels (``util.collective``),
not NCCL.

    trainer = TorchTrainer(
        train_loop, scaling_config=ScalingConfig(num_workers=2))
    result = trainer.fit()

Inside `train_loop`, `torch.distributed` is initialized (gloo) and
`ray_tpu_torch.train.report()` works as with CudaTrainer.
"""

from __future__ import annotations

from dataclasses import dataclass

from ray_tpu_torch.train.backend import Backend, BackendConfig


@dataclass
class TorchConfig(BackendConfig):
    backend: str = "gloo"          # the only supported process-group kind
    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return TorchBackend


def _free_port_on_worker() -> int:
    import socket

    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _setup_torch_process_group(master_addr: str, master_port: int,
                               world_size: int, rank: int,
                               backend: str, timeout_s: float) -> bool:
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        backend=backend, init_method=f"tcp://{master_addr}:{master_port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.is_initialized()


def _shutdown_torch_process_group() -> None:
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        pass


def form_process_group(worker_group, backend: str,
                       timeout_s: float) -> None:
    """Rank 0 picks a port; every worker joins ``backend``'s group at
    rank 0's address (the reference's rendezvous)."""
    import ray_tpu_torch

    world_size = worker_group.num_workers
    meta0 = worker_group.metadata()[0]
    port = worker_group.execute_single(0, _free_port_on_worker)
    ok = ray_tpu_torch.get([
        w.execute.remote(_setup_torch_process_group, meta0["ip"], port,
                         world_size, rank, backend, timeout_s)
        for rank, w in enumerate(worker_group.workers)
    ], timeout=600)
    if not all(ok):
        raise RuntimeError(f"torch process group failed to form: {ok}")


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        if backend_config.backend != "gloo":
            raise ValueError(
                f"backend={backend_config.backend!r}: only 'gloo' is "
                "supported (tensors between the port's ranks go through "
                "its own ring kernels, not NCCL)")
        # The group forms even at world_size 1 (the reference does too):
        # DDP and dist.* calls in the user loop must work at any scale.
        form_process_group(worker_group, backend_config.backend,
                           backend_config.init_timeout_s)

    def on_shutdown(self, worker_group,
                    backend_config: TorchConfig) -> None:
        try:
            worker_group.execute(_shutdown_torch_process_group)
        except Exception:
            pass
