"""Replica actor — hosts one copy of a deployment's user callable: the
port's copy of ``ray_tpu/serve/_private/replica.py``.

Reference: `serve/_private/replica.py` (user callable wrapper, health
checks, graceful shutdown). A replica that leases part of the card
(``num_gpus``) runs under the raylet's ``CUDA_VISIBLE_DEVICES``, set
before this constructor runs; one that leases none never touches CUDA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class Replica:
    def __init__(self, deployment_name: str, serialized_callable: bytes,
                 init_args: tuple, init_kwargs: dict):
        import cloudpickle

        self._name = deployment_name
        cls_or_fn = cloudpickle.loads(serialized_callable)
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
            self._is_function = False
        else:
            self._callable = cls_or_fn
            self._is_function = True
        import threading

        self._num_ongoing = 0
        self._num_served = 0
        # handle_request runs on a thread pool (max_ongoing_requests ->
        # actor max_concurrency); bare += on counters would drift.
        self._stats_lock = threading.Lock()

    def handle_request(self, method_name: str, args: tuple,
                       kwargs: dict, model_id: str = "") -> Any:
        from ray_tpu_torch.serve.multiplex import _reset_model_id, _set_model_id

        # The (method_name, args, kwargs) envelope hides the logical
        # call args from the worker's task-arg resolution, so give
        # ObjectRef elements task-arg semantics here: materialize them
        # in THIS process. This is the disagg two-hop's transfer seam —
        # the router forwards a prefill replica's result ref untouched
        # and the payload moves store-to-store, never through the
        # router.
        if any(isinstance(a, ray_tpu_torch.ObjectRef) for a in args):
            args = tuple(ray_tpu_torch.get(a)
                         if isinstance(a, ray_tpu_torch.ObjectRef) else a
                         for a in args)
        if any(isinstance(v, ray_tpu_torch.ObjectRef) for v in kwargs.values()):
            kwargs = {k: ray_tpu_torch.get(v)
                      if isinstance(v, ray_tpu_torch.ObjectRef) else v
                      for k, v in kwargs.items()}
        with self._stats_lock:
            self._num_ongoing += 1
        token = _set_model_id(model_id)
        try:
            if self._is_function:
                target = self._callable
            elif method_name == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            out = target(*args, **kwargs)
            with self._stats_lock:
                self._num_served += 1
            return out
        finally:
            _reset_model_id(token)
            with self._stats_lock:
                self._num_ongoing -= 1

    def check_health(self) -> bool:
        checker = getattr(self._callable, "check_health", None)
        if checker is not None and not self._is_function:
            checker()
        return True

    def stats(self) -> Dict[str, int]:
        return {"ongoing": self._num_ongoing, "served": self._num_served}

    def prepare_shutdown(self) -> bool:
        """User teardown hook before the controller kills this replica.
        Draining happens CALLER-side (controller._drain_and_kill polls
        stats until ongoing==0) — a replica-side wait would share the
        max_concurrency pool with handle_request and so could never run
        exactly when the replica is saturated."""
        if not self._is_function:
            hook = getattr(self._callable, "__del__", None)
            if hook is not None:
                try:
                    hook()
                except Exception:
                    pass
        return True
