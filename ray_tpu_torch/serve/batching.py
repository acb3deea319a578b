"""Request batching, the port's copy of ``ray_tpu/serve/batching.py``
(reference: `serve/batching.py` `@serve.batch`).

Coalesces concurrent single-item calls into one list-call of the wrapped
function: a model replica on the card should see one padded batch on
the tensor cores, not 16 single-row matmuls.

The replica executes requests on a thread pool (`max_ongoing_requests` →
actor max_concurrency), so batching is thread-based: the first caller to
enqueue becomes the batch leader, waits up to `batch_wait_timeout_s` for
the batch to fill, then runs the wrapped function once and distributes
results to the other callers' futures.
"""

from __future__ import annotations

import concurrent.futures
import functools
import threading
import time
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, wait_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait_s = wait_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: List[Any] = []
        self._futs: List[concurrent.futures.Future] = []

    def submit(self, bound_args: tuple, item: Any) -> Any:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._items.append(item)
            self._futs.append(fut)
            leader = len(self._items) == 1
            if len(self._items) >= self._max:
                self._cond.notify_all()
        if leader:
            self._lead(bound_args)
        return fut.result()

    def _lead(self, bound_args: tuple) -> None:
        deadline = time.monotonic() + self._wait_s
        with self._lock:
            while len(self._items) < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        # Keep leading until the queue drains: late arrivals past the cap
        # (or enqueued while a batch runs) form follow-up batches instead
        # of overflowing this one or stranding leaderless.
        while True:
            with self._lock:
                items = self._items[:self._max]
                futs = self._futs[:self._max]
                del self._items[:self._max]
                del self._futs[:self._max]
            if not items:
                return
            try:
                results = self._fn(*bound_args, items)
                if not isinstance(results, (list, tuple)) \
                        or len(results) != len(items):
                    raise TypeError(
                        f"@serve.batch function must return a list of "
                        f"{len(items)} results (one per input), got "
                        f"{type(results).__name__}")
                for f, r in zip(futs, results):
                    f.set_result(r)
            except Exception as e:  # noqa: BLE001
                for f in futs:
                    if not f.done():
                        f.set_exception(e)


class _BatchedCallable:
    """Descriptor so @serve.batch works on methods and free functions."""

    def __init__(self, fn: Callable, max_batch_size: int, wait_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait_s = wait_s
        self._queues: dict = {}
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn)

    def _queue_for(self, owner) -> _BatchQueue:
        key = id(owner)
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _BatchQueue(
                    self._fn, self._max, self._wait_s)
            return q

    def __reduce__(self):
        # Class attrs ship to replicas via cloudpickle; queues and locks
        # are process-local and rebuild empty on the other side.
        return (_BatchedCallable, (self._fn, self._max, self._wait_s))

    def __call__(self, item: Any) -> Any:          # free function
        return self._queue_for(None).submit((), item)

    def __get__(self, instance, owner=None):       # bound method
        if instance is None:
            return self

        def bound(item: Any) -> Any:
            return self._queue_for(instance).submit((instance,), item)

        bound.__name__ = getattr(self._fn, "__name__", "batched")
        return bound


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """`@serve.batch` — wrapped fn takes a LIST of items and returns a
    list of results of the same length; callers pass single items."""

    def wrap(fn: Callable) -> _BatchedCallable:
        return _BatchedCallable(fn, max_batch_size, batch_wait_timeout_s)

    return wrap(_func) if _func is not None else wrap
