"""ray_tpu_torch.serve — model serving: the port's copy of
``ray_tpu/serve`` (reference: `python/ray/serve/`).

A singleton ServeController actor reconciles deployment specs into
replica actors (`serve/_private/controller.py:84`,
`deployment_state.py:1229`); the data plane routes requests through a
power-of-two-choices replica scheduler
(`replica_scheduler/pow_2_scheduler.py:44`) behind ``DeploymentHandle``.
Replicas may lease part of the card (``num_gpus``) for their model
calls, while the control plane leases none and stays off CUDA.

Not ported yet, each raising where it is asked for: the HTTP and gRPC
ingress (``start``, ``start_grpc``; ``asgi``/``@serve.ingress`` and the
route plane are not exported), ``@serve.batch`` and the declarative
schema (``serve/schema.py``).
"""

from ray_tpu_torch.serve.api import (
    Application, Deployment, delete, deployment, get_app_handle,
    list_applications, run, shutdown, start, start_grpc, status,
)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import (
    get_multiplexed_model_id, multiplexed,
)

__all__ = [
    "Application", "Deployment", "DeploymentHandle", "delete",
    "deployment", "get_app_handle", "get_multiplexed_model_id",
    "list_applications", "multiplexed", "run", "shutdown", "start",
    "start_grpc", "status",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu

_rlu("serve")
del _rlu
