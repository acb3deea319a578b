"""Task specifications — the unit handed from submitters to schedulers.

Role-equivalent to the reference's `src/ray/common/task/task_spec.h` +
`function_descriptor.h`. A TaskSpec is fully picklable and self-contained:
function descriptor (resolved against the GCS function table), serialized
args (inline values or ObjectRef descriptors), resource demand, scheduling
strategy, and retry/return metadata (option surface mirrors
`python/ray/_private/ray_option_utils.py`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.resources import ResourceSet


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass
class FunctionDescriptor:
    """Identifies a remote function/actor class in the GCS function table."""

    module: str
    qualname: str
    function_hash: str  # content hash; key in the GCS KV function table

    def key(self) -> str:
        return f"fn:{self.function_hash}"

    def __repr__(self):
        return f"{self.module}.{self.qualname}"

    def __reduce__(self):
        # Positional-tuple pickling: specs cross the wire on every task
        # submission — dict-based dataclass pickling repeats every field
        # name per instance and is ~3x larger and slower.
        return (FunctionDescriptor,
                (self.module, self.qualname, self.function_hash))


@dataclass
class ArgSpec:
    """One task argument: either an inline serialized value or an ObjectRef."""

    is_ref: bool
    # inline payload (SerializedObject bytes) when not a ref
    inline_data: Optional[bytes] = None
    # object id + owner address when a ref
    object_id: Optional[bytes] = None
    owner_addr: Optional[Tuple[str, int]] = None

    def __reduce__(self):
        return (ArgSpec, (self.is_ref, self.inline_data, self.object_id,
                          self.owner_addr))


@dataclass
class SchedulingStrategySpec:
    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP | NODE_LABEL
    node_id: Optional[bytes] = None
    soft: bool = False
    placement_group_id: Optional[bytes] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False
    hard_labels: Dict[str, List[str]] = field(default_factory=dict)
    soft_labels: Dict[str, List[str]] = field(default_factory=dict)

    def __reduce__(self):
        return (SchedulingStrategySpec,
                (self.kind, self.node_id, self.soft,
                 self.placement_group_id, self.bundle_index,
                 self.capture_child_tasks, self.hard_labels,
                 self.soft_labels))


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function: FunctionDescriptor
    args: List[ArgSpec]
    kwargs_keys: List[str]  # last len(kwargs_keys) args are kwargs
    num_returns: int
    resources: ResourceSet
    owner_addr: Tuple[str, int]  # core-worker RPC address of the owner
    owner_worker_id: WorkerID
    name: str = ""
    scheduling: SchedulingStrategySpec = field(default_factory=SchedulingStrategySpec)
    max_retries: int = 0
    retry_exceptions: Any = False  # bool or list of exception types (pickled ok)
    runtime_env: Optional[Dict[str, Any]] = None
    # actor tasks
    actor_id: Optional[ActorID] = None
    sequence_number: int = -1
    concurrency_group: str = ""
    # actor creation
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    is_async_actor: bool = False
    is_detached: bool = False
    actor_name: str = ""
    namespace: str = ""
    # generators
    is_streaming_generator: bool = False
    generator_backpressure: int = -1
    # tracing
    parent_task_id: Optional[TaskID] = None
    depth: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    # Owner-side scheduling-phase timestamps (PENDING / LEASE_GRANTED
    # wall clocks; see observability.profiling.SCHED_PHASES). Stashed on
    # the spec rather than a side table so the stash dies with the task
    # — retries reuse the same spec object and keep the original submit
    # time. Rides the wire as a small dict; executing workers ignore it.
    phase_ts: Optional[Dict[str, float]] = None
    # Caller's request-scoped trace context (TraceContext.to_wire():
    # {"t": trace_id, "s": span_id, "b": baggage}) — the executing
    # worker restores it around the task body so spans recorded
    # downstream parent under the span active at submit time. Appended
    # last: __reduce__ tolerates missing trailing fields, so old specs
    # deserialize with trace_ctx=None.
    trace_ctx: Optional[Dict[str, Any]] = None

    def __reduce__(self):
        return (_rebuild_task_spec, tuple(
            getattr(self, f) for f in _TASK_SPEC_FIELDS))

    def return_ids(self) -> List[ObjectID]:
        # Generator tasks (num_returns < 0: -1 dynamic, -2 streaming) have
        # one visible return — the generator ref at index 1; yielded items
        # take indices 2, 3, ... as they are produced.
        n = 1 if self.num_returns < 0 else self.num_returns
        return [
            ObjectID.for_task_return(self.task_id, i + 1)
            for i in range(n)
        ]

    def generator_item_id(self, item_index: int) -> ObjectID:
        return ObjectID.for_task_return(self.task_id, item_index + 2)

    def dependencies(self) -> List[bytes]:
        return [a.object_id for a in self.args if a.is_ref]


_TASK_SPEC_FIELDS = tuple(f.name for f in TaskSpec.__dataclass_fields__.values())


def _rebuild_task_spec(*values) -> TaskSpec:
    # Tolerates fields appended in newer versions: missing trailing values
    # fall back to declared defaults (positional prefix construction).
    return TaskSpec(*values)
