"""Model multiplexing, the port's copy of ``ray_tpu/serve/multiplex.py``
(reference: `serve/multiplex.py` +
`serve/api.py` `get_multiplexed_model_id`).

One deployment serves MANY models: each replica lazily loads models on
demand and keeps an LRU of at most `max_num_models_per_replica` (the card's
memory is the budget). Requests carry a model id
(`handle.options(multiplexed_model_id=...)`); the router sends a given
model id to a stable replica (rendezvous hashing) so each model's weights
load on one replica instead of everywhere.
"""

from __future__ import annotations

import contextvars
import functools
import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Optional

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rt_serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the request being handled."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


def _reset_model_id(token) -> None:
    _model_id_ctx.reset(token)


class _MultiplexWrapper:
    """Per-instance LRU of loaded models around a user loader method."""

    def __init__(self, fn: Callable, max_models: int):
        self._fn = fn
        self._max = max_models
        self._per_instance: dict = {}
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn)

    def __reduce__(self):
        # Ships to replicas inside the deployment class; the LRU and lock
        # are process-local and rebuild empty on the other side.
        return (_MultiplexWrapper, (self._fn, self._max))

    def _state(self, instance):
        key = id(instance)
        with self._lock:
            st = self._per_instance.get(key)
            if st is None:
                st = self._per_instance[key] = {
                    "models": OrderedDict(), "lock": threading.Lock(),
                    "loading": {}}
            return st

    def __get__(self, instance, owner=None):
        if instance is None:
            return self

        def bound(model_id: str):
            st = self._state(instance)
            while True:
                with st["lock"]:
                    models = st["models"]
                    if model_id in models:
                        models.move_to_end(model_id)
                        return models[model_id]
                    pending = st["loading"].get(model_id)
                    if pending is None:
                        # We load; others wait (single-flight: a multi-GB
                        # weight load must not run once per concurrent
                        # request).
                        pending = st["loading"][model_id] = threading.Event()
                        loader = True
                    else:
                        loader = False
                if not loader:
                    pending.wait()
                    continue    # re-check the cache (load may have failed)
                try:
                    model = self._fn(instance, model_id)
                except BaseException:
                    with st["lock"]:
                        st["loading"].pop(model_id, None)
                    pending.set()
                    raise
                with st["lock"]:
                    models = st["models"]
                    models[model_id] = model
                    models.move_to_end(model_id)
                    while len(models) > self._max:
                        models.popitem(last=False)   # LRU evict; GC frees
                    st["loading"].pop(model_id, None)
                pending.set()
                return model

        bound.__name__ = getattr(self._fn, "__name__", "multiplexed")
        return bound


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """`@serve.multiplexed` on a loader method `def load(self, model_id)`:
    calls hit an LRU; at most max_num_models_per_replica stay resident."""

    def wrap(fn: Callable) -> _MultiplexWrapper:
        return _MultiplexWrapper(fn, max_num_models_per_replica)

    return wrap(_func) if _func is not None else wrap


def rendezvous_pick(replica_keys, model_id: str):
    """Stable replica choice for a model id (highest-random-weight hash):
    adding/removing a replica only remaps ~1/n of the models."""
    def score(rkey) -> int:
        h = hashlib.blake2b(f"{rkey}:{model_id}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big")

    return max(replica_keys, key=score)
