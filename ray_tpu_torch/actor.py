"""@ray_tpu_torch.remote on classes — actors (reference: `python/ray/actor.py`)."""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Dict, List, Optional

import cloudpickle

_VALID_ACTOR_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "memory", "accelerator_type",
    "max_restarts", "max_task_retries", "max_concurrency", "name",
    "namespace", "lifetime", "get_if_exists", "scheduling_strategy",
    "runtime_env", "concurrency_groups", "_labels",
}


def method(**options):
    """@ray_tpu_torch.method decorator for per-method options
    (reference: `actor.py:53` `@ray.method(num_returns=...)`)."""

    def decorator(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return decorator


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._name = name
        self._options = dict(options or {})

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        refs = w.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs, self._options,
            max_task_retries=self._handle._max_task_retries)
        nr = self._options.get("num_returns", 1)
        if nr == 0:
            return None
        if nr == 1 or isinstance(nr, str):
            # "dynamic"/"streaming" return the single generator ref.
            return refs[0]
        return refs

    def options(self, **options) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           {**self._options, **options})

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference `actor.py` bind); compose with
        ray_tpu_torch.dag.InputNode and experimental_compile()."""
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; use "
            f".{self._name}.remote()")


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str = "Actor",
                 max_task_retries: int = 0,
                 method_options: Optional[Dict[str, Dict]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        self._method_options = method_options or {}
        self._gc_registered = False
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker_or_none()
        if w is not None:
            w.actor_handles.add_ref(actor_id)
            self._gc_registered = True

    def __del__(self):
        if not self._gc_registered:
            return
        try:
            from ray_tpu_torch._private import worker as worker_mod

            w = worker_mod.global_worker_or_none()
            if w is not None:
                w.actor_handles.remove_ref(self._actor_id)
        except BaseException:
            pass

    def __getattr__(self, name: str) -> ActorMethod:
        # Real attributes resolve via __dict__ first; only dunders must not
        # fall through to method synthesis (pickle/copy probe them).
        if name.startswith("__"):
            raise AttributeError(name)
        return ActorMethod(self, name, self._method_options.get(name))

    @property
    def _id(self) -> bytes:
        return self._actor_id

    def _actor_id_hex(self) -> str:
        return self._actor_id.hex()

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


def reduce_actor_handle(handle: ActorHandle):
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker_or_none()
    if w is not None:
        # Handle escapes this process: pin the actor (conservative stand-in
        # for the reference's distributed handle counting).
        w.actor_handles.mark_shared(handle._actor_id)
    return (_rehydrate_handle, (handle._actor_id, handle._class_name,
                                handle._max_task_retries,
                                handle._method_options))


def _rehydrate_handle(actor_id, class_name, max_task_retries, method_options):
    return ActorHandle(actor_id, class_name, max_task_retries, method_options)


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        from ray_tpu_torch.remote_function import reject_num_tpus

        reject_num_tpus(self._options)
        for key in self._options:
            if key not in _VALID_ACTOR_OPTIONS:
                raise ValueError(
                    f"invalid option {key!r} for an actor; valid: "
                    f"{sorted(_VALID_ACTOR_OPTIONS)}")
        self._pickled: Optional[bytes] = None
        self.__name__ = cls.__name__

    def _collect_method_options(self) -> Dict[str, Dict]:
        out = {}
        for name, fn in inspect.getmembers(self._cls, callable):
            opts = getattr(fn, "__ray_tpu_method_options__", None)
            if opts:
                out[name] = opts
        return out

    def _is_async(self) -> bool:
        return any(
            asyncio.iscoroutinefunction(fn)
            for _, fn in inspect.getmembers(self._cls, callable))

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._cls)
        options = dict(self._options)
        options["is_async"] = self._is_async()
        handle = w.create_actor(self._pickled, self.__name__, args, kwargs,
                                options)
        handle._max_task_retries = options.get("max_task_retries", 0)
        handle._method_options = self._collect_method_options()
        return handle

    def remote_many(self, count: int, *args, **kwargs) -> List[ActorHandle]:
        """Create ``count`` identical actors via ONE batched GCS
        registration round-trip — the fleet-bring-up path (a collective
        group's members, a serve deployment's replicas).  Named actors
        cannot be batched: names must be unique."""
        from ray_tpu_torch._private.worker import global_worker

        if self._options.get("name"):
            raise ValueError(
                "remote_many cannot create named actors (names must be "
                "unique); use .options(name=...).remote() per actor")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        w = global_worker()
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._cls)
        options = dict(self._options)
        options["is_async"] = self._is_async()
        handles = w.create_actors(self._pickled, self.__name__, count,
                                  args, kwargs, options)
        method_options = self._collect_method_options()
        for handle in handles:
            handle._max_task_retries = options.get("max_task_retries", 0)
            handle._method_options = method_options
        return handles

    def options(self, **options) -> "ActorClass":
        clone = ActorClass(self._cls, {**self._options, **options})
        clone._pickled = self._pickled
        return clone

    def bind(self, *args, **kwargs):
        raise NotImplementedError(
            "ActorClass.bind is not supported: create the actor with "
            ".remote() and bind its methods (actor.method.bind(...))")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()")
