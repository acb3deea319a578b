"""ray_tpu_torch.serve — model serving: the port's copy of
``ray_tpu/serve`` (reference: `python/ray/serve/`).

A singleton ServeController actor reconciles deployment specs into
replica actors (`serve/_private/controller.py:84`,
`deployment_state.py:1229`); the data plane routes requests through a
power-of-two-choices replica scheduler
(`replica_scheduler/pow_2_scheduler.py:44`) behind ``DeploymentHandle``.
Replicas may lease part of the card (``num_gpus``) for their model
calls, while the control plane leases none and stays off CUDA.

The ingress: an HTTP proxy (``start``, ``serve/_private/proxy.py``, on
the standard library's ``asyncio`` streams) and a gRPC proxy
(``start_grpc``, ``grpcio`` imported lazily) share one push-invalidated
route table (``_private/route_plane.py``); ``@serve.ingress`` binds an
ASGI app (``asgi``), ``@serve.batch`` coalesces concurrent calls and
``deploy_config`` / ``deploy_config_file`` deploy declarative configs
(``schema.py``).
"""

from ray_tpu_torch.serve import asgi
from ray_tpu_torch.serve.api import (
    Application, Deployment, delete, deployment, get_app_handle,
    list_applications, run, shutdown, start, start_grpc, status,
)
from ray_tpu_torch.serve.asgi import ingress
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import (
    get_multiplexed_model_id, multiplexed,
)
from ray_tpu_torch.serve.schema import (
    deploy_config, deploy_config_file, import_application,
)

__all__ = [
    "Application", "Deployment", "DeploymentHandle", "asgi", "batch",
    "delete", "deploy_config", "deploy_config_file", "deployment",
    "get_app_handle", "get_multiplexed_model_id", "import_application",
    "ingress", "list_applications", "multiplexed", "run", "shutdown",
    "start", "start_grpc", "status",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu

_rlu("serve")
del _rlu
