"""Shared client<->server marshalling.

Refs/handles are swapped at PICKLE time via `reducer_override`, so they
are caught anywhere in the object graph — including inside user classes —
not just in plain arg containers. Unpickling server-side (inside an
`active_server()` scope) rebuilds the real pinned objects; client-side it
rebuilds thin refs registered with the ClientWorker.

A ``torch.Tensor`` crosses as the object store carries it
(``_private/serialization.py``): a CUDA tensor comes back on the
receiver's current CUDA device, and a receiver without one raises."""

from __future__ import annotations

import contextlib
import io
import sys
from typing import Any

import cloudpickle

_ACTIVE_SERVER = None


@contextlib.contextmanager
def active_server(server):
    """Unpickles within this scope resolve markers against `server`."""
    global _ACTIVE_SERVER
    prev, _ACTIVE_SERVER = _ACTIVE_SERVER, server
    try:
        yield
    finally:
        _ACTIVE_SERVER = prev


def _rebuild_ref(object_id: bytes):
    if _ACTIVE_SERVER is not None:
        return _ACTIVE_SERVER._ref(object_id)
    # Client side: a thin ref that registers with the ClientWorker.
    from ray_tpu_torch._private.object_ref import ObjectRef

    return ObjectRef(object_id, None, b"client")


def _rebuild_actor(actor_id: bytes, class_name: str):
    if _ACTIVE_SERVER is not None:
        return _ACTIVE_SERVER._actor_handle(actor_id, class_name)
    from ray_tpu_torch.actor import ActorHandle

    return ActorHandle(actor_id, class_name)


class ClientPickler(cloudpickle.CloudPickler):
    """Reduces ObjectRef/ActorHandle anywhere in the graph to wire
    rebuilders (client -> server direction). `pin` (optional) is called
    on each ref id so the server can pin results it sends back."""

    def __init__(self, file, pin=None):
        super().__init__(file, protocol=cloudpickle.DEFAULT_PROTOCOL)
        self._pin = pin

    def reducer_override(self, obj):
        from ray_tpu_torch.actor import ActorHandle
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            if self._pin is not None:
                self._pin(obj)
            return (_rebuild_ref, (obj.binary(),))
        if isinstance(obj, ActorHandle):
            return (_rebuild_actor, (obj._actor_id, obj._class_name))
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) is torch.Tensor:
            from ray_tpu_torch._private.serialization import _reduce_tensor

            return _reduce_tensor(obj)
        # Chain to CloudPickler: it uses reducer_override for by-value
        # pickling of __main__/unimportable classes and functions.
        return super().reducer_override(obj)


def dumps(obj: Any, pin=None) -> bytes:
    buf = io.BytesIO()
    ClientPickler(buf, pin=pin).dump(obj)
    return buf.getvalue()
