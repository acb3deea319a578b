"""ray_tpu_torch.train — distributed training orchestration: the port of
``ray_tpu/train`` (Ray Train parity; CudaTrainer/CudaBackend in place of
the reference's JaxTrainer/JaxBackend)."""

from ray_tpu_torch.train._internal.session import (
    get_context, get_dataset_shard, report,
)
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.sharded_checkpoint import (  # noqa: F401
    load_sharded, save_sharded,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig, FailureConfig, Result, RunConfig, ScalingConfig,
)
from ray_tpu_torch.train.cuda_backend import CudaBackend, CudaConfig
from ray_tpu_torch.train.torch_backend import TorchBackend, TorchConfig
from ray_tpu_torch.train.trainer import (
    CudaTrainer, DataParallelTrainer, TorchTrainer,
)
from ray_tpu_torch.train._internal.backend_executor import TrainingFailedError

__all__ = [
    "CudaTrainer", "DataParallelTrainer", "CudaBackend", "CudaConfig",
    "TorchTrainer", "TorchBackend", "TorchConfig",
    "Backend", "BackendConfig", "ScalingConfig", "RunConfig",
    "FailureConfig", "CheckpointConfig", "Checkpoint", "Result",
    "report", "get_context", "get_dataset_shard", "TrainingFailedError",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu

_rlu("train")
del _rlu
