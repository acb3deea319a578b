"""Mutable shared-memory channels — the compiled-DAG substrate.

Reference: `src/ray/core_worker/experimental_mutable_object_manager.h` +
`python/ray/experimental/channel/` — reusable zero-copy slots that a
static DAG writes/reads repeatedly, bypassing the per-call task path
(lease, RPC, object store) entirely.

Design: one single-writer/single-reader slot in POSIX shared memory
(`/dev/shm`). Header = three aligned u64 counters + a closed flag:

    write_seq  — bumped by the writer AFTER the payload is in place
    ack_seq    — bumped by the reader AFTER it consumed the payload
    length     — payload byte length

Backpressure is the protocol: the writer blocks until `ack_seq ==
write_seq` (previous value consumed), the reader blocks until
`write_seq > ack_seq`. Each counter has exactly one writing side, so
torn updates can't happen (aligned 8-byte stores), and the payload is
never rewritten while the reader may touch it. Polling backs off
50µs → 1ms: one write+read round-trip is ~100µs vs ~1ms+ for a task
RPC. Same-host only (like the reference's mutable objects, which ride
node-local shm / NVLink).

The header and the payload's pickle (protocol 5) are the reference's
byte for byte, so a channel is written and read across the two
packages. One difference: a ``torch.Tensor`` crosses as the object
store carries it (``_private/serialization.py``), so a CUDA tensor is
read back onto the reader's current CUDA device, and a reader without
one raises instead of getting a CPU tensor.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import time
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Optional

_U64 = struct.Struct("<Q")
_OFF_WRITE = 0
_OFF_ACK = 8
_OFF_LEN = 16
_OFF_CLOSED = 24
_HEADER_SIZE = 32

DEFAULT_BUFFER_SIZE = 8 * 1024 * 1024


class ChannelClosedError(Exception):
    """The peer tore the channel down."""


class ChannelFullError(Exception):
    """Serialized value exceeds the channel's fixed buffer."""


def _untrack(shm: shared_memory.SharedMemory) -> None:
    # Attachers must not let the resource tracker unlink the segment when
    # *their* process exits — the creator owns the lifetime.
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa
    except Exception:
        pass


def _dumps(value: Any) -> bytes:
    """``pickle.dumps(value, protocol=5)``, with tensors reduced as the
    object store reduces them. Without torch loaded the value holds no
    tensor and the bytes are plain pickle's."""
    torch = sys.modules.get("torch")
    if torch is None:
        return pickle.dumps(value, protocol=5)
    from ray_tpu_torch._private.serialization import _reduce_tensor

    sink = io.BytesIO()
    pickler = pickle.Pickler(sink, protocol=5)
    pickler.dispatch_table = {torch.Tensor: _reduce_tensor}
    pickler.dump(value)
    return sink.getvalue()


class Channel:
    """One SPSC mutable slot. `create=True` allocates (owner side);
    readers/writers in other processes attach by name."""

    def __init__(self, name: Optional[str] = None, *,
                 buffer_size: int = DEFAULT_BUFFER_SIZE,
                 create: bool = False):
        if create:
            name = name or f"rtch-{uuid.uuid4().hex[:16]}"
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_HEADER_SIZE + buffer_size)
            self._shm.buf[:_HEADER_SIZE] = b"\0" * _HEADER_SIZE
        else:
            if name is None:
                raise ValueError("attaching requires a channel name")
            self._shm = shared_memory.SharedMemory(name=name)
            _untrack(self._shm)
        self.name = name
        self._owner = create
        self._capacity = self._shm.size - _HEADER_SIZE

    # ------------------------------------------------------------ counters
    def _get(self, off: int) -> int:
        return _U64.unpack_from(self._shm.buf, off)[0]

    def _set(self, off: int, val: int) -> None:
        _U64.pack_into(self._shm.buf, off, val)

    @property
    def closed(self) -> bool:
        return self._shm.buf[_OFF_CLOSED] != 0

    # ------------------------------------------------------------------ io
    @staticmethod
    def serialize(value: Any) -> bytes:
        """Pre-serialize once when the same value fans out to several
        channels (pair with write_serialized)."""
        return _dumps(value)

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        self.write_serialized(self.serialize(value), timeout)

    def write_serialized(self, payload: bytes,
                         timeout: Optional[float] = None) -> None:
        if len(payload) > self._capacity:
            raise ChannelFullError(
                f"serialized value is {len(payload)} bytes; channel buffer "
                f"is {self._capacity} (pass a larger buffer_size at "
                f"compile time)")
        self._wait(lambda: self._get(_OFF_ACK) == self._get(_OFF_WRITE),
                   timeout, "write")
        self._shm.buf[_HEADER_SIZE:_HEADER_SIZE + len(payload)] = payload
        self._set(_OFF_LEN, len(payload))
        self._set(_OFF_WRITE, self._get(_OFF_WRITE) + 1)

    def read(self, timeout: Optional[float] = None) -> Any:
        self._wait(lambda: self._get(_OFF_WRITE) > self._get(_OFF_ACK),
                   timeout, "read")
        n = self._get(_OFF_LEN)
        value = pickle.loads(bytes(self._shm.buf[_HEADER_SIZE:
                                                 _HEADER_SIZE + n]))
        self._set(_OFF_ACK, self._get(_OFF_ACK) + 1)
        return value

    def _wait(self, ready, timeout: Optional[float], op: str) -> None:
        start = time.monotonic()
        deadline = None if timeout is None else start + timeout
        while not ready():
            if self.closed:
                raise ChannelClosedError(
                    f"channel {self.name} closed during {op}")
            now = time.monotonic()
            if deadline is not None and now > deadline:
                raise TimeoutError(f"channel {self.name} {op} timed out")
            # Hot path: spin ~200µs (a pipelined peer answers within that),
            # then 50µs naps to 20ms, then 1ms naps — so a hop costs ~µs
            # when the DAG is being driven and ~1ms wake-up when idle.
            waited = now - start
            if waited < 200e-6:
                continue
            time.sleep(50e-6 if waited < 20e-3 else 1e-3)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Mark closed (wakes both sides), keep the mapping."""
        try:
            self._shm.buf[_OFF_CLOSED] = 1
        except (ValueError, TypeError):
            pass

    def release(self) -> None:
        """Detach; the owner also unlinks the segment."""
        self.close()
        try:
            self._shm.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    def __reduce__(self):
        # Handing a channel to another process pickles the *name*; the
        # receiver attaches to the same shm segment.
        return (_attach, (self.name,))


def _attach(name: str) -> "Channel":
    return Channel(name)
