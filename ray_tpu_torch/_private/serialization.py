"""Object serialization with zero-copy out-of-band buffers.

Role-equivalent to the reference's `_private/serialization.py:110`
(`SerializationContext`): cloudpickle for arbitrary Python objects, with numpy
array payloads carried out-of-band via pickle protocol 5 so they land in / are
read from shared memory without copies. numpy payloads keep the reference's
byte layout exactly.

``torch.Tensor`` payloads travel the same way (numpy has no bf16, the port's
working dtype): each tensor is one out-of-band buffer, a ``uint8`` view of
the storage bytes it spans, with its dtype, shape and strides in the
pickle. A ``get`` rebuilds it over the store's memory without a copy
(a read-only buffer, such as an inlined small object, is copied once).
Such a tensor is a view of the sealed object and torch has no read-only
tensor: an in-place write through it changes the object for every later
``get`` on the node, so a reader that writes takes ``.clone()`` first. A
CUDA tensor is copied to the host once at ``put`` and comes back on the
getter's current CUDA device; a getter without one raises. torch is imported
only when a payload holds a tensor.

Store layout for a sealed object::

    u32 magic | u32 n_buffers | u64 pickle_len | n*u64 buffer_lens
    | pickle bytes | pad to 64 | buffer0 | pad to 64 | buffer1 | ...

ObjectRefs and ActorHandles embedded inside values are reduced to portable
descriptors and rehydrated against the current worker on load (the hook is
installed by `ray_tpu_torch._private.worker`).
"""

from __future__ import annotations

import pickle
import struct
import sys
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import cloudpickle
import numpy as np

_MAGIC = 0x52545055  # "RTPU"
_ALIGN = 64
_HDR = struct.Struct("<II Q")


class SerializedObject:
    """A pickled payload plus out-of-band buffers, ready to write."""

    __slots__ = ("meta", "buffers", "total_size")

    def __init__(self, meta: bytes, buffers: Sequence[memoryview]):
        self.meta = meta
        self.buffers = [b.cast("B") if b.format != "B" or b.ndim != 1 else b
                        for b in map(memoryview, buffers)]
        size = _HDR.size + 8 * len(self.buffers)
        size = _aligned(size + len(meta))
        for b in self.buffers:
            size = _aligned(size + b.nbytes)
        self.total_size = size

    def write_into(self, dest: memoryview) -> None:
        off = _HDR.size + 8 * len(self.buffers)
        _HDR.pack_into(dest, 0, _MAGIC, len(self.buffers), len(self.meta))
        for i, b in enumerate(self.buffers):
            struct.pack_into("<Q", dest, _HDR.size + 8 * i, b.nbytes)
        dest[off:off + len(self.meta)] = self.meta
        off = _aligned(off + len(self.meta))
        for b in self.buffers:
            dest[off:off + b.nbytes] = b
            off = _aligned(off + b.nbytes)

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size)
        self.write_into(memoryview(out))
        return bytes(out)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class SerializationContext:
    """Per-worker serializer; custom reducer hooks are pluggable."""

    def __init__(self):
        # type -> reducer(obj) -> (reconstructor, args)
        self._custom_reducers: dict = {}
        # Called after each deserialize with [(oid, owner_addr)] of refs
        # rehydrated from the payload whose owner is another process —
        # the worker registers these as borrows.
        self._on_deserialize: List[Callable[[Any], None]] = []
        # Per-thread hand-off of refs embedded in the latest serialize():
        # serialize runs concurrently on executor/actor/driver threads, so
        # this must never be shared mutable state.
        self._tls = threading.local()

    @property
    def last_contained_refs(self) -> List:
        return getattr(self._tls, "contained", [])

    def register_reducer(self, type_: type, reducer: Callable) -> None:
        self._custom_reducers[type_] = reducer

    def serialize(self, value: Any) -> SerializedObject:
        buffers: List[pickle.PickleBuffer] = []

        class _Pickler(cloudpickle.Pickler):
            dispatch_table = dict(getattr(cloudpickle.Pickler, "dispatch_table", {}))

        for type_, reducer in self._custom_reducers.items():
            _Pickler.dispatch_table[type_] = reducer
        torch = sys.modules.get("torch")
        if torch is not None:
            # Without torch in the process the value holds no tensor.
            _Pickler.dispatch_table[torch.Tensor] = _reduce_tensor

        import io

        from ray_tpu_torch._private import object_ref as _oref

        sink = io.BytesIO()
        pickler = _Pickler(sink, protocol=5, buffer_callback=buffers.append)
        _oref.begin_serialize_capture()
        try:
            pickler.dump(value)
        finally:
            # Refs embedded in the value, for the borrower protocol: the
            # caller decides whether they become object-keyed holders
            # (stored values) or stay covered by task-dep pins (args).
            self._tls.contained = _oref.end_serialize_capture()
        views = [b.raw() for b in buffers]
        return SerializedObject(sink.getvalue(), views)

    def deserialize(self, data: memoryview, keepalive: Any = None) -> Any:
        data = memoryview(data)
        magic, n_buffers, meta_len = _HDR.unpack_from(data, 0)
        if magic != _MAGIC:
            raise ValueError("corrupt object payload (bad magic)")
        sizes = [
            struct.unpack_from("<Q", data, _HDR.size + 8 * i)[0]
            for i in range(n_buffers)
        ]
        off = _HDR.size + 8 * n_buffers
        meta = bytes(data[off:off + meta_len])
        off = _aligned(off + meta_len)
        bufs = []
        for size in sizes:
            view = data[off:off + size]
            if keepalive is not None:
                view = _keepalive_buffer(view, keepalive)
            bufs.append(view)
            off = _aligned(off + size)
        from ray_tpu_torch._private import object_ref as _oref

        _oref.begin_deserialize_capture()
        try:
            value = pickle.loads(meta, buffers=bufs)
        finally:
            borrowed = _oref.end_deserialize_capture()
        # Register in-bound borrows with their owners BEFORE the value is
        # usable: for task args the caller still holds the task-dep pin,
        # so the registration can never race the owner's free.
        for hook in self._on_deserialize:
            hook(borrowed)
        return value


class _KeepaliveArray(np.ndarray):
    """uint8 view of a store buffer that pins the backing mapping.

    pickle's out-of-band loads do ``memoryview(buffer)`` internally, so
    the buffer must support the C buffer protocol — a pure-Python proxy
    (PEP 688 ``__buffer__``) only exists from 3.12. An ndarray subclass
    exports the protocol natively on every version, values rebuilt from
    the buffer keep it alive through ``.base``, and the extra attribute
    keeps the MappedObject (the raylet reader ref) alive with it."""

    _keepalive: Any = None


def _keepalive_buffer(view: memoryview, keepalive: Any) -> np.ndarray:
    arr = np.frombuffer(view, np.uint8).view(_KeepaliveArray)
    arr._keepalive = keepalive
    return arr


def _reduce_tensor(t):
    """One out-of-band buffer over the bytes ``t`` spans in its storage,
    with what rebuilds the view over it."""
    import torch

    if t.layout != torch.strided or t.is_quantized:
        return t.__reduce_ex__(5)
    device = t.device.type
    if device not in ("cpu", "cuda"):
        raise TypeError(f"cannot put a tensor on {t.device}")
    requires_grad = t.requires_grad
    t = t.detach().resolve_conj().resolve_neg()
    if device == "cuda":
        t = t.to("cpu")
    span = 0
    if t.numel():
        span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    raw = torch.as_strided(t, (span,), (1,), t.storage_offset())
    arr = raw.view(torch.uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(arr), str(t.dtype),
                             tuple(t.shape), tuple(t.stride()), device,
                             requires_grad)


def _rebuild_tensor(buf, dtype: str, shape, stride, device: str,
                    requires_grad: bool):
    import torch

    arr = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    if not arr.flags.writeable:
        # torch has no read-only tensor: a write into a read-only mapping
        # would crash the process, so such a buffer is copied once.
        arr = arr.copy()
    dtype = getattr(torch, dtype.split(".")[-1])
    flat = (torch.from_numpy(arr).view(dtype) if arr.size
            else torch.empty(0, dtype=dtype))
    t = torch.as_strided(flat, shape, stride, 0)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA tensor was put in the object store and this process "
                "has no CUDA device to get it onto")
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if requires_grad:
        t.requires_grad_(True)
    return t


def serialize_error(exc: BaseException) -> bytes:
    """Best-effort pickling of an exception for cross-process propagation."""
    import traceback

    try:
        return cloudpickle.dumps((exc, traceback.format_exc()))
    except Exception:
        return cloudpickle.dumps(
            (RuntimeError(f"{type(exc).__name__}: {exc}"), traceback.format_exc())
        )


def deserialize_error(payload: bytes) -> Tuple[BaseException, str]:
    return cloudpickle.loads(payload)
