"""ray_tpu_torch.client — remote driver proxy ("ray://" equivalent).

Reference: `python/ray/util/client/` — a proxy server runs a driver
inside the cluster; thin clients connect over RPC and the whole public
API (tasks, actors, get/put/wait) executes server-side. On the port
this is how a process that holds no CUDA context (a laptop, a
``CUDA_VISIBLE_DEVICES=""`` job) drives GPU actors in a cluster. The C++
frontend in ``cpp/`` speaks to the same server (``cross_language``).

Usage:
    server:  ray_tpu_torch.client.serve(port)        # inside any driver
             python -m ray_tpu_torch.client.server --address <gcs> --port P
    client:  ray_tpu_torch.init(address="ray_tpu_torch://host:port")
"""

__all__ = ["ClientServer", "ClientWorker", "serve"]


def __getattr__(name):
    # Lazy, so that ``python -m ray_tpu_torch.client.server`` runs the
    # server module once (as ``__main__``), not a second imported copy.
    if name in ("ClientServer", "serve"):
        from ray_tpu_torch.client import server

        return getattr(server, name)
    if name == "ClientWorker":
        from ray_tpu_torch.client.worker import ClientWorker

        return ClientWorker
    raise AttributeError(name)
