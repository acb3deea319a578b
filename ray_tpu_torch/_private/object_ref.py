"""ObjectRef — the handle to a (possibly pending) immutable object.

Reference-counted by the owning worker: creating and destroying Python
ObjectRef instances adjusts the owner's local refcount (reference:
`src/ray/core_worker/reference_count.h:61`). Serializing a ref into a task
argument or another object enters the borrower protocol (see
`reference_count.py`): the recipient registers with the owner and the
object is freed once every borrower drains.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_owner_worker_id", "_registered",
                 "__weakref__")

    def __init__(self, object_id: bytes, owner_addr: Tuple[str, int],
                 owner_worker_id: bytes, _register: bool = True):
        self._id = object_id
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._owner_worker_id = owner_worker_id
        self._registered = False
        if _register:
            from ray_tpu_torch._private import worker as worker_mod

            w = worker_mod.global_worker_or_none()
            if w is not None:
                w.reference_counter.add_local_ref(self._id)
                self._registered = True

    # -- identity -----------------------------------------------------------
    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner_addr(self) -> Optional[Tuple[str, int]]:
        return self._owner_addr

    @property
    def owner_worker_id(self) -> bytes:
        return self._owner_worker_id

    def object_id(self) -> ObjectID:
        return ObjectID(self._id)

    def task_id(self):
        return ObjectID(self._id).task_id()

    # -- lifecycle ----------------------------------------------------------
    def __del__(self):
        if not self._registered:
            return
        try:
            from ray_tpu_torch._private import worker as worker_mod

            w = worker_mod.global_worker_or_none()
            if w is not None:
                # NEVER decref inline: __del__ can fire inside any
                # allocation on a thread already holding worker locks
                # (self-deadlock via _free_object). deque.append is the
                # only GC-safe operation; the worker drains it at entry
                # points and from its release-drainer task.
                w.defer_release(self._id)
        except BaseException:
            # Interpreter teardown: module globals may already be gone.
            pass

    # -- hashing / equality -------------------------------------------------
    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self.hex()})"

    # -- awaitable ----------------------------------------------------------
    def __await__(self):
        """``await ref`` resolves to the object's VALUE (reference
        semantics), not the one-element list ``async_get`` returns."""
        from ray_tpu_torch._private import worker as worker_mod

        async def _resolve():
            values = await worker_mod.global_worker().async_get([self])
            return values[0]

        return _resolve().__await__()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        import concurrent.futures
        import threading

        from ray_tpu_torch._private import worker as worker_mod

        fut: concurrent.futures.Future = concurrent.futures.Future()
        w = worker_mod.global_worker()

        def _wait():
            try:
                fut.set_result(w.get_objects([self], timeout=None)[0])
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)

        threading.Thread(target=_wait, daemon=True).start()
        return fut


# Thread-local capture of refs crossing a serialize/deserialize boundary,
# feeding the borrower protocol (reference: borrowed-ref bookkeeping in
# `reference_count.cc`). The serializer/worker installs a list before the
# (de)pickling pass and collects it after.
_capture = threading.local()


def begin_serialize_capture() -> None:
    _capture.out = []


def end_serialize_capture():
    out = getattr(_capture, "out", None)
    _capture.out = None
    return out or []


def begin_deserialize_capture() -> None:
    _capture.inb = []


def end_deserialize_capture():
    inb = getattr(_capture, "inb", None)
    _capture.inb = None
    return inb or []


def reduce_object_ref(ref: ObjectRef):
    """Pickle reducer: pin with a pending share (a recipient will claim
    it by registering as a borrower, or the TTL sweep expires it), and
    rehydrate on load."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker_or_none()
    if w is not None:
        w.reference_counter.add_pending_share(ref.binary())
    out = getattr(_capture, "out", None)
    if out is not None:
        out.append((ref.binary(), ref.owner_addr))
    return _rehydrate_ref, (ref.binary(), ref.owner_addr, ref.owner_worker_id)


def _rehydrate_ref(object_id, owner_addr, owner_worker_id):
    ref = ObjectRef(object_id, owner_addr, owner_worker_id)
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker_or_none()
    if w is not None and owner_addr is not None:
        if tuple(owner_addr) != w.addr:
            w.reference_counter.add_borrowed(object_id, tuple(owner_addr))
            inb = getattr(_capture, "inb", None)
            if inb is not None:
                inb.append((object_id, tuple(owner_addr)))
        # else: the bytes came home to the owner. Do NOT consume a pending
        # share here — shares are fungible per object, and the one we'd
        # pop could be the only pin covering a different still-in-flight
        # copy; the TTL sweep retires it instead.
    return ref


class ObjectRefGenerator:
    """Iterator over the return refs of a generator task
    (``num_returns="streaming"``).

    Reference: `python/ray/_raylet.pyx:272` (ObjectRefGenerator): the remote
    call returns this handle immediately; item refs become available
    incrementally as the executing worker reports them
    (ReportGeneratorItemReturns — here the `report_generator_item` owner
    RPC). Iterating blocks until the next item exists or the generator
    finishes (StopIteration). Only usable in the owner process.
    """

    def __init__(self, task_id: bytes, owner_addr, owner_worker_id: bytes):
        self._task_id = task_id
        self._owner_addr = tuple(owner_addr)
        self._owner_worker_id = owner_worker_id
        self._next_index = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        from ray_tpu_torch._private import worker as worker_mod

        ref = worker_mod.global_worker().next_generator_ref(
            self._task_id, self._next_index)
        self._next_index += 1
        return ref

    def completed(self) -> int:
        """Number of item refs produced so far."""
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod.global_worker().generator_progress(self._task_id)[0]

    def __repr__(self):
        return f"ObjectRefGenerator(task={self._task_id.hex()})"
