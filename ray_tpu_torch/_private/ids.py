"""Structured binary IDs for the ray_tpu_torch runtime.

Design follows the reference ID nesting scheme (ray `src/ray/common/id.h`,
`src/ray/design_docs/id_specification.md:1`): JobID (4B) is a suffix of
ActorID (16B), which is a suffix of TaskID (24B), which is a prefix of
ObjectID (28B = TaskID + 4B return-index).  This lets any component recover
the job from an actor, the actor from a task, and the creating task from an
object with pure byte slicing — no lookups.

All IDs are immutable value types, hashable, and serialize as raw bytes.
"""

from __future__ import annotations

import os
import threading

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 16
_TASK_ID_SIZE = 24
_OBJECT_ID_SIZE = 28
_UNIQUE_ID_SIZE = 28  # NodeID / WorkerID / PlacementGroupID


class BaseID:
    """Common machinery for fixed-size binary IDs."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class ActorID(BaseID):
    """16 bytes: 12 random + 4 job-id suffix."""

    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        return cls(b"\xff" * (cls.SIZE - JobID.SIZE) + job_id.binary())

    def is_nil(self) -> bool:
        # Normal tasks carry nil_for_job (0xff prefix + job suffix).
        n = self.SIZE - JobID.SIZE
        return self._bytes[:n] == b"\xff" * n

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE:])


class TaskID(BaseID):
    """24 bytes: 8 unique + 16 actor-id suffix."""

    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(
            os.urandom(cls.SIZE - ActorID.SIZE)
            + ActorID.nil_for_job(job_id).binary()
        )

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(os.urandom(cls.SIZE - ActorID.SIZE) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(b"\x00" * (cls.SIZE - ActorID.SIZE) + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[-ActorID.SIZE:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    """28 bytes: 24-byte creating TaskID + 4-byte little-endian return index."""

    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid collision with
        # return indices (reference: ObjectID::FromIndex with negative index).
        return cls(task_id.binary() + (0x80000000 | put_index).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE:], "little") & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(self._bytes[-1] & 0x80)

    def job_id(self) -> JobID:
        return self.task_id().job_id()


class UniqueID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class NodeID(UniqueID):
    pass


class WorkerID(UniqueID):
    pass


class PlacementGroupID(BaseID):
    """16 bytes: 12 random + 4 job-id suffix (mirrors ActorID layout)."""

    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE:])


class _IndexCounter:
    """Thread-safe monotonically increasing counter (per-worker task/put index)."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
