"""ray_tpu_torch.workflow — durable task DAGs with storage-backed resume.

Reference: `python/ray/workflow/` (`workflow_executor.py:32`,
`workflow_state.py`, `workflow_state_from_storage.py`): steps compose into
a DAG; every step's output is checkpointed to storage as it completes, so
a crashed/interrupted workflow resumes from its last finished step —
completed steps replay from storage, never re-execute.

API (classic step style)::

    from ray_tpu_torch import workflow

    workflow.init("/path/to/storage")

    @workflow.step
    def fetch(x): ...

    @workflow.step
    def combine(a, b): ...

    out = combine.step(fetch.step(1), fetch.step(2)).run("my_wf")
    # after a crash: workflow.resume("my_wf")

A step also takes the task options of ``remote`` (``num_gpus=1``,
``num_cpus``, ``resources``, ...), as Ray 1.x's ``workflow.step`` did:
``@workflow.step(num_gpus=1)`` runs the step on a leased card. The
storage layout is the JAX package's, file for file.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch

_storage_dir: Optional[str] = None


def init(storage_dir: str) -> None:
    global _storage_dir
    _storage_dir = os.path.abspath(storage_dir)
    os.makedirs(_storage_dir, exist_ok=True)


def _storage() -> str:
    if _storage_dir is None:
        raise RuntimeError("call workflow.init(storage_dir) first")
    return _storage_dir


class Step:
    """One DAG node: a function + args (args may be other Steps).

    Per-step options (reference: `workflow.options(max_retries=...,
    catch_exceptions=...)`): `max_retries` re-executes a crashed/raising
    step before failing the workflow; `catch_exceptions=True` makes the
    step's checkpointed output `(result, None)` or `(None, exception)`
    so downstream steps decide how to proceed. `ray_options` are the
    step task's `remote` options (`num_gpus`, ...)."""

    def __init__(self, fn, args: tuple, kwargs: dict, name: str,
                 max_retries: int = 0, catch_exceptions: bool = False,
                 ray_options: Optional[Dict[str, Any]] = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name
        self.max_retries = max_retries
        self.catch_exceptions = catch_exceptions
        self.ray_options = dict(ray_options or {})
        self.step_id: Optional[str] = None  # assigned at run (deterministic)

    def options(self, *, max_retries: Optional[int] = None,
                catch_exceptions: Optional[bool] = None,
                **ray_options) -> "Step":
        # Copy semantics, matching _StepBuilder.options: a Step node
        # reused in two DAG positions must not inherit options applied
        # to one of them.
        return Step(
            self.fn, self.args, self.kwargs, self.name,
            max_retries=(self.max_retries if max_retries is None
                         else max_retries),
            catch_exceptions=(self.catch_exceptions
                              if catch_exceptions is None
                              else catch_exceptions),
            ray_options={**self.ray_options, **ray_options})

    def run(self, workflow_id: str) -> Any:
        return run(self, workflow_id)

    def run_async(self, workflow_id: str):
        raise NotImplementedError(
            "run_async is not supported (as in the JAX package): use run()")


class _StepBuilder:
    def __init__(self, fn, max_retries: int = 0,
                 catch_exceptions: bool = False,
                 ray_options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._max_retries = max_retries
        self._catch_exceptions = catch_exceptions
        self._ray_options = dict(ray_options or {})
        self.__name__ = getattr(fn, "__name__", "step")

    def step(self, *args, **kwargs) -> Step:
        return Step(self._fn, args, kwargs, self.__name__,
                    max_retries=self._max_retries,
                    catch_exceptions=self._catch_exceptions,
                    ray_options=self._ray_options)

    def options(self, *, max_retries: Optional[int] = None,
                catch_exceptions: Optional[bool] = None,
                **ray_options) -> "_StepBuilder":
        return _StepBuilder(
            self._fn,
            self._max_retries if max_retries is None else max_retries,
            self._catch_exceptions if catch_exceptions is None
            else catch_exceptions,
            {**self._ray_options, **ray_options})

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def step(fn=None, *, max_retries: int = 0, catch_exceptions: bool = False,
         **ray_options):
    if ray_options:
        from ray_tpu_torch.remote_function import validate_task_options

        validate_task_options(dict(ray_options))
    if fn is None:
        return lambda f: _StepBuilder(f, max_retries, catch_exceptions,
                                      ray_options)
    return _StepBuilder(fn, max_retries, catch_exceptions, ray_options)


class EventStep(Step):
    """A DAG node that completes when an external event arrives
    (reference: `workflow.wait_for_event` over event_listener.py).
    Executes DRIVER-side (it only polls); its delivered payload
    checkpoints like any step output, so resume replays instead of
    re-waiting, and the listener's `event_checkpointed` ack fires only
    after the checkpoint is durable."""

    def __init__(self, listener, timeout=None, name: str = "wait_for_event"):
        super().__init__(fn=None, args=(), kwargs={}, name=name)
        self.listener = listener
        self.timeout = timeout

    def options(self, *, max_retries=None,
                catch_exceptions=None) -> "EventStep":
        # Step.options copy semantics would produce a plain Step (fn=None,
        # listener dropped) that crashes at execution.
        out = EventStep(self.listener, self.timeout, self.name)
        out.max_retries = (self.max_retries if max_retries is None
                           else max_retries)
        out.catch_exceptions = (self.catch_exceptions
                                if catch_exceptions is None
                                else catch_exceptions)
        return out


# ---------------------------------------------------------------- executor

def _assign_ids(root: Step) -> List[Step]:
    """Deterministic ids from DAG structure (stable across resumes)."""
    order: List[Step] = []
    counter: Dict[str, int] = {}

    def visit(node: Step):
        for a in list(node.args) + list(node.kwargs.values()):
            if isinstance(a, Step):
                visit(a)
        if node.step_id is None:
            idx = counter.get(node.name, 0)
            counter[node.name] = idx + 1
            node.step_id = f"{node.name}_{idx}"
            order.append(node)

    visit(root)
    return order  # topological: dependencies before dependents


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


def _step_output_path(workflow_id: str, step_id: str) -> str:
    return os.path.join(_wf_dir(workflow_id), f"step_{step_id}.pkl")


def _set_status(workflow_id: str, status: str) -> None:
    meta = os.path.join(_wf_dir(workflow_id), "status.json")
    with open(meta + ".tmp", "w") as f:
        json.dump({"status": status, "ts": time.time()}, f)
    os.replace(meta + ".tmp", meta)


def run(dag: Step, workflow_id: str) -> Any:
    """Execute the DAG durably. The DAG definition itself persists first so
    `resume(workflow_id)` works without re-supplying code."""
    wf_dir = _wf_dir(workflow_id)
    os.makedirs(wf_dir, exist_ok=True)
    dag_path = os.path.join(wf_dir, "dag.pkl")
    if not os.path.exists(dag_path):
        with open(dag_path, "wb") as f:
            cloudpickle.dump(dag, f)
    return _execute(dag, workflow_id)


def _execute(dag: Step, workflow_id: str) -> Any:
    _set_status(workflow_id, "RUNNING")
    steps = _assign_ids(dag)
    results: Dict[str, Any] = {}

    try:
        for node in steps:  # topological order
            out_path = _step_output_path(workflow_id, node.step_id)
            if os.path.exists(out_path):
                with open(out_path, "rb") as f:
                    results[node.step_id] = pickle.load(f)
                continue  # checkpointed by a previous run: replay, not rerun

            def resolve(v):
                return results[v.step_id] if isinstance(v, Step) else v

            if isinstance(node, EventStep):
                node.listener.bind(workflow_id, _storage())
                value = node.listener.poll_for_event(timeout=node.timeout)
                with open(out_path + ".tmp", "wb") as f:
                    cloudpickle.dump(value, f)
                os.replace(out_path + ".tmp", out_path)
                try:
                    node.listener.event_checkpointed(value)
                except Exception:
                    pass  # ack is best-effort; the checkpoint is durable
                results[node.step_id] = value
                continue

            args = tuple(resolve(a) for a in node.args)
            kwargs = {k: resolve(v) for k, v in node.kwargs.items()}
            remote_fn = ray_tpu_torch.remote(node.fn)
            if node.ray_options:
                remote_fn = remote_fn.options(**node.ray_options)
            if node.max_retries:
                # Explicit per-step retries also retry on application
                # exceptions; steps WITHOUT explicit retries keep the
                # global crash-retry default (never override it with 0).
                remote_fn = remote_fn.options(
                    max_retries=node.max_retries, retry_exceptions=True)
            if node.catch_exceptions:
                try:
                    value = ray_tpu_torch.get(
                        remote_fn.remote(*args, **kwargs), timeout=3600)
                    value = (value, None)
                except Exception as e:  # noqa: BLE001
                    # Hand the user the application exception, not the
                    # RayTaskError transport wrapper.
                    value = (None, getattr(e, "cause", e))
            else:
                value = ray_tpu_torch.get(
                    remote_fn.remote(*args, **kwargs), timeout=3600)
            with open(out_path + ".tmp", "wb") as f:
                # cloudpickle: catch_exceptions outputs can hold
                # dynamically-created RayTaskError subclasses that plain
                # pickle cannot serialize by reference.
                cloudpickle.dump(value, f)
            os.replace(out_path + ".tmp", out_path)  # atomic checkpoint
            results[node.step_id] = value
    except BaseException:
        _set_status(workflow_id, "FAILED")
        raise
    _set_status(workflow_id, "SUCCEEDED")
    return results[dag.step_id]


def resume(workflow_id: str) -> Any:
    """Continue an interrupted workflow from its persisted DAG + completed
    step checkpoints."""
    dag_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    if not os.path.exists(dag_path):
        raise KeyError(f"no persisted workflow '{workflow_id}'")
    with open(dag_path, "rb") as f:
        dag = cloudpickle.load(f)
    return _execute(dag, workflow_id)


def get_status(workflow_id: str) -> Optional[str]:
    meta = os.path.join(_wf_dir(workflow_id), "status.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["status"]


def get_output(workflow_id: str) -> Any:
    """Output of a finished workflow (from storage; no re-execution)."""
    with open(os.path.join(_wf_dir(workflow_id), "dag.pkl"), "rb") as f:
        dag = cloudpickle.load(f)
    steps = _assign_ids(dag)
    out_path = _step_output_path(workflow_id, steps[-1].step_id)
    if not os.path.exists(out_path):
        raise RuntimeError(f"workflow '{workflow_id}' has no final output "
                           "(resume it first)")
    with open(out_path, "rb") as f:
        return pickle.load(f)


def list_all() -> List[Dict[str, Any]]:
    out = []
    root = _storage()
    for wf_id in sorted(os.listdir(root)):
        status = get_status(wf_id)
        if status is not None:
            out.append({"workflow_id": wf_id, "status": status})
    return out

from ray_tpu_torch.workflow.events import (  # noqa: E402
    EventListener, FileEventListener, HTTPEventProvider, wait_for_event,
)

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu  # noqa: E402

_rlu("workflow")
del _rlu
