"""Meshes, sharding rules and training steps for the port: meshes of
virtual ranks (``mesh``), the param and batch specs over them
(``sharding``), the train step (``train_step``: one device, or a mesh),
ZeRO data parallelism over a ring of ranks (``zero``) and the pipeline
schedule (``pipeline``)."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, data_parallel_mesh, device_inventory, discover_devices, fsdp_mesh,
    make_mesh, mesh_axis_size,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding, PartitionSpec, batch_sharding, batch_spec,
    context_parallel_attention, llama_param_shardings, llama_param_specs,
    replicated, shard_params,
)
from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState, build_eval_step, build_train_step, create_train_state,
    state_shardings,
)
from ray_tpu_torch.parallel.zero import (  # noqa: F401
    ZeroTrainState, build_replicated_train_step, build_zero_train_step,
    constrain_opt_state, create_zero_state, zero_moment_shardings,
)

__all__ = [
    "make_mesh", "data_parallel_mesh", "discover_devices",
    "fsdp_mesh", "mesh_axis_size",
    "context_parallel_attention",
    "llama_param_specs", "llama_param_shardings", "batch_spec",
    "batch_sharding", "shard_params", "replicated", "TrainState",
    "create_train_state", "build_train_step", "build_eval_step",
    "state_shardings",
    "ZeroTrainState", "build_zero_train_step", "create_zero_state",
    "zero_moment_shardings", "constrain_opt_state",
]

