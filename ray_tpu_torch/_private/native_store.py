"""ctypes binding for the native arena store (``csrc/arena_store.cpp``).

The port's own copy of the reference's ``native/arena_store.cpp``; it
builds on first use with g++ (no pybind11 — plain C ABI) into
``ray_tpu_torch/_build/`` (gitignored), under a name keyed by a hash of
the source and flags, so an edited source rebuilds and processes that
race the first build each write their own temporary file and rename it
into place. `load()` returns None when the toolchain is unavailable, and
the store falls back to the file-per-object backend.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "arena_store.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
_BUILD_LOCK = threading.Lock()
_LIB = None
_LOAD_FAILED = False


def _so_path() -> str:
    h = hashlib.sha256(open(_SRC, "rb").read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libarena_store-{h.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so_path)


def _configure(lib) -> None:
    u64 = ctypes.c_uint64
    lib.rtpu_store_open.restype = ctypes.c_void_p
    lib.rtpu_store_open.argtypes = [ctypes.c_char_p, u64]
    lib.rtpu_store_close.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_create.restype = u64
    lib.rtpu_store_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64]
    lib.rtpu_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(u64), ctypes.POINTER(u64)]
    lib.rtpu_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_pin.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.rtpu_store_addref.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.rtpu_store_evict.argtypes = [ctypes.c_void_p, u64, ctypes.c_char_p,
                                     u64]
    lib.rtpu_store_lru_pinned.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, u64,
        ctypes.POINTER(u64), ctypes.POINTER(u64)]
    lib.rtpu_store_entry_flags.restype = None
    lib.rtpu_store_entry_flags.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.POINTER(ctypes.c_uint64)]
    lib.rtpu_store_stats.argtypes = [ctypes.c_void_p, u64 * 4]


def load():
    """Build (once) + dlopen the arena store; None if unavailable."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        try:
            so_path = _so_path()
            if not os.path.exists(so_path):
                _build(so_path)
            lib = ctypes.CDLL(so_path)
            _configure(lib)
            _LIB = lib
        except Exception:
            _LOAD_FAILED = True
    return _LIB


_UINT64_MAX = 2 ** 64 - 1


class ArenaStore:
    """Thin OO wrapper over the C handle (ids are hex strings)."""

    def __init__(self, arena_path: str, capacity: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native arena store unavailable")
        self._h = self._lib.rtpu_store_open(arena_path.encode(), capacity)
        if not self._h:
            raise RuntimeError(f"could not open arena at {arena_path}")
        self.path = arena_path
        self.capacity = capacity

    def create(self, oid: bytes, size: int) -> Optional[int]:
        off = self._lib.rtpu_store_create(self._h, oid.hex().encode(), size)
        return None if off == _UINT64_MAX else off

    def seal(self, oid: bytes) -> bool:
        return self._lib.rtpu_store_seal(self._h, oid.hex().encode()) == 0

    def get(self, oid: bytes) -> Optional[Tuple[int, int]]:
        """(offset, size) of a sealed object, else None."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_store_get(self._h, oid.hex().encode(),
                                      ctypes.byref(off), ctypes.byref(size))
        return (off.value, size.value) if rc == 0 else None

    def contains(self, oid: bytes) -> bool:
        return bool(self._lib.rtpu_store_contains(self._h,
                                                  oid.hex().encode()))

    def delete(self, oid: bytes) -> bool:
        return self._lib.rtpu_store_delete(self._h, oid.hex().encode()) == 0

    def addref(self, oid: bytes, delta: int) -> int:
        return self._lib.rtpu_store_addref(self._h, oid.hex().encode(),
                                           delta)

    def pin(self, oid: bytes, pinned: bool) -> None:
        self._lib.rtpu_store_pin(self._h, oid.hex().encode(),
                                 1 if pinned else 0)

    def evict_for(self, needed: int) -> List[bytes]:
        buf = ctypes.create_string_buffer(64 * 1024)
        n = self._lib.rtpu_store_evict(self._h, needed, buf, len(buf))
        out: List[bytes] = []
        raw = buf.raw
        pos = 0
        for _ in range(n):
            end = raw.index(b"\0", pos)
            if end == pos:
                break
            out.append(bytes.fromhex(raw[pos:end].decode()))
            pos = end + 1
        return out

    def lru_pinned(self) -> Optional[Tuple[bytes, int, int]]:
        buf = ctypes.create_string_buffer(128)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_store_lru_pinned(
            self._h, buf, len(buf), ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        return bytes.fromhex(buf.value.decode()), off.value, size.value

    def entry_flags(self, oid: bytes) -> Tuple[int, int, int, int]:
        """(found, sealed, pinned, refs) — debug/diagnostic surface."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.rtpu_store_entry_flags(self._h, oid.hex().encode(), out)
        return tuple(out)

    def stats(self) -> Tuple[int, int, int, int]:
        out = (ctypes.c_uint64 * 4)()
        self._lib.rtpu_store_stats(self._h, out)
        return tuple(out)

    def close(self) -> None:
        if self._h:
            self._lib.rtpu_store_close(self._h)
            self._h = None
