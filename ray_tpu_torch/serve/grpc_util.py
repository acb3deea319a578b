"""Client helpers for the serve gRPC ingress, the port's copy of
``ray_tpu/serve/grpc_util.py`` (reference: `serve/_private/grpc_util.py`).
See `_private/grpc_proxy.py` for the service contract — generic bytes
methods with app/method selection in invocation metadata."""

from __future__ import annotations

import json
from typing import Any, Iterator, Optional

from ray_tpu_torch.serve._private.grpc_proxy import PREDICT, PREDICT_STREAM


class ServeGrpcClient:
    """Thin convenience wrapper over a grpc channel."""

    def __init__(self, target: str):
        import grpc

        self._channel = grpc.insecure_channel(target)
        self._predict = self._channel.unary_unary(PREDICT)
        self._predict_stream = self._channel.unary_stream(PREDICT_STREAM)

    @staticmethod
    def _metadata(application: str, method: str, model_id: Optional[str]):
        md = [("application", application), ("method", method)]
        if model_id:
            md.append(("multiplexed_model_id", model_id))
        return md

    @staticmethod
    def _encode(payload: Any) -> bytes:
        if payload is None:
            return b""
        if isinstance(payload, bytes):
            return payload
        return json.dumps(payload).encode()

    def predict(self, payload: Any = None, *, application: str = "default",
                method: str = "__call__", model_id: Optional[str] = None,
                timeout: float = 120.0) -> bytes:
        return self._predict(
            self._encode(payload), timeout=timeout,
            metadata=self._metadata(application, method, model_id))

    def predict_stream(self, payload: Any = None, *,
                       application: str = "default",
                       method: str = "__call__",
                       timeout: float = 120.0) -> Iterator[bytes]:
        return self._predict_stream(
            self._encode(payload), timeout=timeout,
            metadata=self._metadata(application, method, None))

    def close(self) -> None:
        self._channel.close()
