"""DeploymentHandle — the Python-level way to call a deployment: the
port's copy of ``ray_tpu/serve/handle.py``.

Reference: `serve/handle.py` (DeploymentHandle.remote -> DeploymentResponse
with .result()); supports composition (handles passed into other
deployments rehydrate in the replica process).
"""

from __future__ import annotations

from typing import Any, Optional

import ray_tpu_torch


class DeploymentResponse:
    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout: float = 120.0) -> Any:
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response (reference: handle.options(stream=True) ->
    DeploymentResponseGenerator): iterate to receive items as the replica
    yields them."""

    def __init__(self, ref_gen):
        self._gen = ref_gen

    def __iter__(self):
        for ref in self._gen:
            yield ray_tpu_torch.get(ref, timeout=120)

    @property
    def ref_generator(self):
        return self._gen


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._call(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: str,
                 multiplexed_model_id: str = "", stream: bool = False):
        self._app = app_name
        self._deployment = deployment_name
        self._model_id = multiplexed_model_id
        self._stream = stream
        self._router = None

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        """Request options (reference: handle.options(multiplexed_model_id=…)
        routes to a replica already holding that model;
        handle.options(stream=True) returns a DeploymentResponseGenerator
        over the replica's yielded items). Unspecified options keep the
        current handle's values — chained .options() calls compose."""
        clone = DeploymentHandle(
            self._app, self._deployment,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id,
            self._stream if stream is None else stream)
        clone._router = self._router    # share the router + inflight view
        return clone

    def _get_router(self):
        if self._router is None:
            from ray_tpu_torch.serve._private.controller import (
                get_or_create_controller,
            )
            from ray_tpu_torch.serve._private.router import Router

            self._router = Router(get_or_create_controller(), self._app,
                                  self._deployment)
        return self._router

    def _call(self, method: str, args: tuple, kwargs: dict):
        ref = self._get_router().assign_request(method, args, kwargs,
                                                model_id=self._model_id,
                                                stream=self._stream)
        if self._stream:
            return DeploymentResponseGenerator(ref)
        return DeploymentResponse(ref)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._call("__call__", args, kwargs)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    # Handles serialize into replicas for model composition; the router is
    # process-local state and rebuilds lazily after rehydration.
    def __reduce__(self):
        return DeploymentHandle, (self._app, self._deployment,
                                  self._model_id)

    def __repr__(self):
        return f"DeploymentHandle({self._app}/{self._deployment})"
