"""Training steps for the port: one device (``train_step``) and data
parallelism with a ZeRO-sharded update over a ring of virtual ranks
(``zero``)."""

from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState, build_eval_step, build_train_step, create_train_state,
)
from ray_tpu_torch.parallel.zero import (  # noqa: F401
    ZeroTrainState, build_replicated_train_step, build_zero_train_step,
    create_zero_state,
)
