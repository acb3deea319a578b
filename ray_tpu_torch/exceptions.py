"""Public exception types (reference: `python/ray/exceptions.py`)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class RayTaskError(RayTpuError):
    """Wraps an exception raised inside a remote task/actor method.

    Re-raised on `get()` at the caller, carrying the remote traceback.
    """

    def __init__(self, cause: BaseException, remote_traceback: str = "",
                 task_name: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_name = task_name
        super().__init__(
            f"task {task_name or '<unknown>'} failed: "
            f"{type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}"
        )

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that isinstance-matches the original cause but
        still carries the remote traceback when displayed."""
        cause = self.cause
        if isinstance(cause, RayTaskError):
            return cause
        try:
            cls = type(cause)
            new = RayTaskError.__new__(RayTaskError)
            # Dynamic subclass so `except OriginalError` works at the caller.
            derived = type(
                "RayTaskError(" + cls.__name__ + ")", (RayTaskError, cls), {})
            new.__class__ = derived
            new.cause = cause
            new.remote_traceback = self.remote_traceback
            new.task_name = self.task_name
            new.args = (str(self),)
            return new
        except TypeError:
            return self


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead; calls can never succeed."""


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get()` exceeded its timeout."""


class ObjectLostError(RayTpuError):
    """The object's value was lost from every node and cannot be recovered."""


class OwnerDiedError(ObjectLostError):
    """The object's owner died, poisoning the object (reference semantics:
    owner failure fails all objects it owns)."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via `cancel()`."""


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class RaySystemError(RayTpuError):
    pass


class OutOfMemoryError(WorkerCrashedError):
    """Raised when a worker was OOM-killed by the raylet memory monitor
    (reference: `ray.exceptions.OutOfMemoryError`). Subclasses
    WorkerCrashedError so existing retry/except paths keep working."""
