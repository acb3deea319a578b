"""Training steps for the port (one device so far)."""

from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState, build_train_step, create_train_state,
)
