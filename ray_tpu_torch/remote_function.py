"""@ray_tpu_torch.remote on functions (reference: `python/ray/remote_function.py`)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import cloudpickle

# Option surface mirrors the reference's central validation table
# (`python/ray/_private/ray_option_utils.py`).
_VALID_TASK_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "memory",
    "accelerator_type", "max_retries", "retry_exceptions", "num_returns",
    "scheduling_strategy", "runtime_env", "name", "_labels",
}


def reject_num_tpus(options: Dict[str, Any]) -> None:
    """The inverse of the reference's guard: this port schedules NVIDIA
    cards, so a request for TPUs names the option to use instead."""
    if "num_tpus" in options:
        raise ValueError(
            "ray_tpu_torch schedules NVIDIA GPUs: use num_gpus instead of "
            "num_tpus")


def validate_task_options(options: Dict[str, Any]) -> None:
    reject_num_tpus(options)
    for key in options:
        if key not in _VALID_TASK_OPTIONS:
            raise ValueError(
                f"invalid option {key!r} for a remote function; valid: "
                f"{sorted(_VALID_TASK_OPTIONS)}")
    nr = options.get("num_returns", 1)
    if isinstance(nr, str):
        if nr not in ("dynamic", "streaming"):
            raise ValueError(
                'num_returns must be an int, "dynamic", or "streaming"')
    elif not (isinstance(nr, int) and nr >= 0):
        raise ValueError("num_returns must be a non-negative int")


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._options = dict(options or {})
        validate_task_options(self._options)
        self._pickled: Optional[bytes] = None
        self._fn_hash: Optional[str] = None
        self.__name__ = getattr(fn, "__name__", "remote_function")
        self.__doc__ = getattr(fn, "__doc__", None)

    def _ensure_exported(self, worker) -> str:
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._function)
        # Re-export per driver session: a module-level @remote function
        # outlives init()/shutdown() cycles, and a cached hash from a
        # previous cluster's GCS function table is unknown to the next
        # one ("function ... not found in the GCS function table").
        # Keyed on the worker's random id — job ids restart at 1 per
        # cluster so they collide across sessions, and id(worker) could
        # be recycled after GC.
        token = worker.worker_id
        if self._fn_hash is None or getattr(self, "_export_token",
                                            None) != token:
            self._fn_hash = worker.export_function(self._pickled)
            self._export_token = token
        return self._fn_hash

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        fn_hash = self._ensure_exported(w)
        refs = w.submit_task(fn_hash, self.__name__, args, kwargs,
                             self._options)
        nr = self._options.get("num_returns", 1)
        if nr == 0:
            return None
        if nr == 1 or isinstance(nr, str):
            # "dynamic" -> ref resolving to the item-ref list;
            # "streaming" -> an ObjectRefGenerator.
            return refs[0]
        return refs

    def options(self, **options) -> "RemoteFunction":
        merged = {**self._options, **options}
        clone = RemoteFunction(self._function, merged)
        clone._pickled = self._pickled
        clone._fn_hash = self._fn_hash
        clone._export_token = getattr(self, "_export_token", None)
        return clone

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference `remote_function.py` bind)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; use "
            f"{self.__name__}.remote()")
