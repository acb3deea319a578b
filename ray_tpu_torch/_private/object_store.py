"""Per-node shared-memory object store (plasma-equivalent).

Role-equivalent to the reference's plasma store
(`src/ray/object_manager/plasma/store.cc:1`, `object_lifecycle_manager.h`,
`eviction_policy.h`, `plasma_allocator.h`): one store per node, hosted
*inside the raylet process* (as plasma runs inside the raylet —
`object_manager.cc:32`), holding sealed immutable objects in shared memory
with LRU eviction, pinning for primary copies, and disk fallback (spilling)
under memory pressure.

Two backends behind one interface:

- **native** (default): a C++ arena allocator (`native/arena_store.cpp`,
  bound via ctypes) — one mmap'd tmpfs file per node, first-fit free list
  with coalescing, C-side LRU eviction. Clients receive (arena path,
  offset, size) and map the arena once per process; create/get cost an
  allocator walk instead of per-object file syscalls. This is plasma's
  actual design (mmap'd arenas + dlmalloc + "FD passing" = sharing the
  arena mapping).
- **files**: one tmpfs file per object (pure-Python fallback when the
  native toolchain is unavailable; also selectable with
  ``RAY_TPU_object_store_backend=files``).

Clients (workers/drivers on the node) call create/seal/get via the raylet
RPC channel and then mmap directly — object bytes never cross the RPC.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import GlobalConfig


class ObjectStoreFullError(Exception):
    pass


# Diagnostic: trace every client addref with a stack (flag read once —
# the env doesn't change mid-process and addref is on the get hot path).
_DEBUG_ADDREF = bool(os.environ.get("RTPU_DEBUG_ADDREF"))


@dataclass
class _Entry:
    object_id: bytes
    size: int
    path: str                    # arena path (native) or object file (files)
    offset: int = 0
    sealed: bool = False
    pinned: bool = False
    spilled_path: Optional[str] = None
    last_access: float = field(default_factory=time.monotonic)
    seal_event: asyncio.Event = field(default_factory=asyncio.Event)


class NodeObjectStore:
    """The node-side store state machine. All methods run on the raylet loop."""

    def __init__(self, capacity_bytes: int, shm_dir: str, spill_dir: str,
                 node_hex: str, backend: Optional[str] = None):
        self.capacity = capacity_bytes
        self.used = 0
        self._shm_dir = shm_dir
        self._spill_dir = spill_dir
        self._prefix = f"rtpu-{node_hex[:12]}-"
        self._entries: Dict[bytes, _Entry] = {}
        os.makedirs(spill_dir, exist_ok=True)
        self.num_evictions = 0
        self.num_spills = 0
        self.num_restores = 0
        self.spill_time_s = 0.0
        self.restore_time_s = 0.0

        backend = backend or getattr(GlobalConfig, "object_store_backend",
                                     "native")
        self._arena = None
        self._arena_map: Optional[mmap.mmap] = None
        if backend == "native":
            try:
                from ray_tpu_torch._private.native_store import ArenaStore

                self._arena_path = os.path.join(
                    shm_dir, self._prefix + "arena")
                self._arena = ArenaStore(self._arena_path, capacity_bytes)
                f = open(self._arena_path, "r+b")
                self._arena_map = mmap.mmap(f.fileno(), capacity_bytes)
                self._arena_file = f
            except Exception:
                self._arena = None  # fall back to file-per-object
        self.backend = "native" if self._arena is not None else "files"

    # -- paths --------------------------------------------------------------
    def _path_for(self, object_id: bytes) -> str:
        return os.path.join(self._shm_dir, self._prefix + object_id.hex())

    # -- create / seal ------------------------------------------------------
    async def _with_full_retry(self, fn, attempts: int = 8,
                               delay_s: float = 0.15):
        """Client buffer releases land asynchronously: a store-full
        condition where every extent is reader-pinned usually clears
        within milliseconds once in-flight release RPCs arrive. One
        shared policy for every async entry point."""
        for i in range(attempts):
            try:
                return fn()
            except ObjectStoreFullError:
                if i == attempts - 1:
                    raise
                await asyncio.sleep(delay_s)

    async def create_async(self, object_id: bytes,
                           size: int) -> Tuple[str, int]:
        return await self._with_full_retry(
            lambda: self.create(object_id, size))

    async def put_bytes_async(self, object_id: bytes,
                              payload: bytes) -> None:
        return await self._with_full_retry(
            lambda: self.put_bytes(object_id, payload))

    def create(self, object_id: bytes, size: int) -> Tuple[str, int]:
        """Allocate space; returns (mmap path, offset-within-path)."""
        if object_id in self._entries:
            entry = self._entries[object_id]
            if entry.spilled_path is not None:
                # The previous copy's arena extent was freed by the spill —
                # its recorded offset is stale. Restore first so the caller
                # gets a live extent, never memory owned by another object.
                self._restore(entry)
            if entry.sealed or entry.size == size:
                return entry.path, entry.offset  # idempotent re-create
            raise ValueError("object already being created with different size")
        if size > self.capacity:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity {self.capacity}")
        if self._arena is not None:
            offset = self._arena_create(object_id, size)
            entry = _Entry(object_id, size, self._arena_path, offset)
        else:
            self._ensure_space(size)
            path = self._path_for(object_id)
            with open(path, "wb") as f:
                f.truncate(size)
            entry = _Entry(object_id, size, path)
            self.used += size
        self._entries[object_id] = entry
        return entry.path, entry.offset

    def _arena_create(self, object_id: bytes, size: int) -> int:
        offset = self._arena.create(object_id, size)
        if offset is None:
            # 1) LRU-evict unpinned sealed copies (C side picks victims).
            for evicted in self._arena.evict_for(size):
                e = self._entries.pop(evicted, None)
                if e is not None and e.spilled_path is None:
                    self.num_evictions += 1
            offset = self._arena.create(object_id, size)
        while offset is None:
            # 2) Spill pinned primaries (LRU first) to disk.
            victim = self._arena.lru_pinned()
            if victim is None:
                detail = ", ".join(
                    f"{oid.hex()[:6]}(py sealed={e.sealed} "
                    f"pinned={e.pinned} "
                    f"spilled={e.spilled_path is not None} "
                    f"C={self._arena.entry_flags(oid)})"
                    for oid, e in list(self._entries.items())[:16])
                raise ObjectStoreFullError(
                    f"need {size} bytes; arena exhausted and nothing "
                    f"spillable [{detail}]")
            self._spill_arena(victim)
            offset = self._arena.create(object_id, size)
        self.used = self._arena.stats()[1]
        return offset

    def seal(self, object_id: bytes) -> None:
        entry = self._entries.get(object_id)
        if entry is None:
            raise KeyError(f"seal of unknown object {object_id.hex()}")
        if self._arena is not None and entry.spilled_path is None:
            self._arena.seal(object_id)
        entry.sealed = True
        entry.last_access = time.monotonic()
        entry.seal_event.set()

    def put_bytes(self, object_id: bytes, payload: bytes) -> None:
        """Create+write+seal in one step (used by the pull path)."""
        if self.contains(object_id):
            return
        path, offset = self.create(object_id, len(payload))
        if self._arena is not None:
            _populate(self._arena_map, offset, len(payload),
                      _MADV_POPULATE_WRITE)
            self._arena_map[offset:offset + len(payload)] = payload
        else:
            with open(path, "r+b") as f:
                f.write(payload)
        self.seal(object_id)

    # -- read ---------------------------------------------------------------
    def contains(self, object_id: bytes) -> bool:
        e = self._entries.get(object_id)
        return e is not None and e.sealed and e.spilled_path is None

    async def get(self, object_id: bytes, timeout: Optional[float]
                  ) -> Optional[Tuple[str, int, int]]:
        """Wait for a local sealed copy; returns (path, size, offset)."""
        entry = self._entries.get(object_id)
        if entry is None:
            if timeout is None or timeout <= 0:
                return None
            deadline = time.monotonic() + timeout
            while entry is None and time.monotonic() < deadline:
                await asyncio.sleep(0.005)
                entry = self._entries.get(object_id)
            if entry is None:
                return None
        if not entry.sealed:
            try:
                await asyncio.wait_for(
                    entry.seal_event.wait(),
                    None if timeout is None else max(timeout, 0.001),
                )
            except asyncio.TimeoutError:
                return None
        if entry.spilled_path is not None:
            # Re-check per attempt: a concurrent getter may restore this
            # entry while we sleep (spilled_path goes None and the spill
            # file is gone — calling _restore again would crash).
            await self._with_full_retry(
                lambda: (self._restore(entry)
                         if entry.spilled_path is not None else None))
        entry.last_access = time.monotonic()
        if self._arena is not None:
            # refresh C-side LRU stamp
            self._arena.get(object_id)
        return entry.path, entry.size, entry.offset

    def write_into(self, object_id: bytes, offset: int, data: bytes) -> None:
        """Server-side write (pull path): into the unsealed object."""
        entry = self._entries[object_id]
        if self._arena is not None:
            base = entry.offset + offset
            self._arena_map[base:base + len(data)] = data
        else:
            with open(entry.path, "r+b") as f:
                f.seek(offset)
                f.write(data)

    def read_bytes(self, object_id: bytes, offset: int, length: int) -> bytes:
        """Server-side read for serving remote pulls (chunked)."""
        entry = self._entries[object_id]
        if entry.spilled_path is not None:
            self._restore(entry)
        if self._arena is not None:
            base = entry.offset + offset
            return bytes(self._arena_map[base:base + length])
        with open(entry.path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def size_of(self, object_id: bytes) -> int:
        return self._entries[object_id].size

    # -- client mapping refs (arena only; per-object files survive unlink
    #    under an existing mmap, so the files backend needs none) ----------
    def addref_client(self, object_id: bytes) -> None:
        if self._arena is not None and object_id in self._entries:
            if _DEBUG_ADDREF:
                import sys
                import traceback
                sys.stderr.write(f"ADDREF {object_id.hex()[:6]}\n"
                                 + "".join(traceback.format_stack()[-4:]))
            self._arena.addref(object_id, 1)

    def release_client(self, object_id: bytes) -> None:
        if self._arena is not None and object_id in self._entries:
            self._arena.addref(object_id, -1)

    # -- pin / delete -------------------------------------------------------
    def pin(self, object_id: bytes) -> None:
        e = self._entries.get(object_id)
        if e is not None:
            e.pinned = True
            if self._arena is not None and e.spilled_path is None:
                self._arena.pin(object_id, True)

    def unpin(self, object_id: bytes) -> None:
        e = self._entries.get(object_id)
        if e is not None:
            e.pinned = False
            if self._arena is not None and e.spilled_path is None:
                self._arena.pin(object_id, False)

    def delete(self, object_ids: List[bytes]) -> None:
        for oid in object_ids:
            entry = self._entries.pop(oid, None)
            if entry is None:
                continue
            if self._arena is not None:
                if entry.spilled_path is None:
                    self._arena.delete(oid)
                    self.used = self._arena.stats()[1]
                else:
                    try:
                        os.unlink(entry.spilled_path)
                    except FileNotFoundError:
                        pass
                continue
            self.used -= entry.size if entry.spilled_path is None else 0
            for p in (entry.path, entry.spilled_path):
                if p is not None and p != getattr(self, "_arena_path", None):
                    try:
                        os.unlink(p)
                    except FileNotFoundError:
                        pass

    # -- eviction / spilling (files backend + spill common path) ------------
    def _ensure_space(self, needed: int) -> None:
        if self.used + needed <= self.capacity:
            return
        candidates = sorted(
            (e for e in self._entries.values()
             if e.sealed and e.spilled_path is None),
            key=lambda e: e.last_access,
        )
        for entry in candidates:
            if self.used + needed <= self.capacity:
                break
            if entry.pinned:
                self._spill(entry)
            else:
                self.used -= entry.size
                self.num_evictions += 1
                try:
                    os.unlink(entry.path)
                except FileNotFoundError:
                    pass
                del self._entries[entry.object_id]
        if self.used + needed > self.capacity:
            raise ObjectStoreFullError(
                f"need {needed} bytes but only "
                f"{self.capacity - self.used} available after eviction")

    def _spill_target(self, object_id: bytes) -> str:
        return os.path.join(self._spill_dir,
                            self._prefix + object_id.hex())

    def _spill(self, entry: _Entry) -> None:
        t0 = time.perf_counter()
        dest = self._spill_target(entry.object_id)
        shutil.move(entry.path, dest)
        entry.spilled_path = dest
        self.used -= entry.size
        self.num_spills += 1
        self.spill_time_s += time.perf_counter() - t0

    def _spill_arena(self, victim: Tuple[bytes, int, int]) -> None:
        t0 = time.perf_counter()
        oid, offset, size = victim
        dest = self._spill_target(oid)
        with open(dest, "wb") as f:
            f.write(self._arena_map[offset:offset + size])
        self._arena.delete(oid)
        entry = self._entries.get(oid)
        if entry is not None:
            entry.spilled_path = dest
        self.num_spills += 1
        self.spill_time_s += time.perf_counter() - t0

    def _restore(self, entry: _Entry) -> None:
        t0 = time.perf_counter()
        if self._arena is not None:
            offset = self._arena_create(entry.object_id, entry.size)
            with open(entry.spilled_path, "rb") as f:
                self._arena_map[offset:offset + entry.size] = f.read()
            os.unlink(entry.spilled_path)
            entry.spilled_path = None
            entry.offset = offset
            self._arena.seal(entry.object_id)
            if entry.pinned:
                self._arena.pin(entry.object_id, True)
        else:
            self._ensure_space(entry.size)
            shutil.move(entry.spilled_path, entry.path)
            entry.spilled_path = None
            self.used += entry.size
        self.num_restores += 1
        self.restore_time_s += time.perf_counter() - t0

    # -- stats --------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        if self._arena is not None:
            cap, used, _n, evictions = self._arena.stats()
            self.used = used
            self.num_evictions = max(self.num_evictions, evictions)
        pinned_bytes = 0
        spilled_bytes = 0
        for e in self._entries.values():
            if e.spilled_path is not None:
                spilled_bytes += e.size
            elif e.pinned:
                pinned_bytes += e.size
        return {
            "backend": self.backend,
            "capacity": self.capacity,
            "used": self.used,
            "num_objects": len(self._entries),
            "pinned_bytes": pinned_bytes,
            "spilled_bytes": spilled_bytes,
            "num_evictions": self.num_evictions,
            "num_spills": self.num_spills,
            "num_restores": self.num_restores,
            "spill_time_s": self.spill_time_s,
            "restore_time_s": self.restore_time_s,
        }

    def object_table(self, limit: Optional[int] = None
                     ) -> List[Dict[str, Any]]:
        """Per-object rows for memory introspection (``memory_summary``,
        ``GET /api/memory``), largest first."""
        now = time.monotonic()
        rows = [{
            "object_id": e.object_id.hex(),
            "size": e.size,
            "sealed": e.sealed,
            "pinned": e.pinned,
            "spilled": e.spilled_path is not None,
            "idle_s": max(now - e.last_access, 0.0),
        } for e in self._entries.values()]
        rows.sort(key=lambda r: r["size"], reverse=True)
        return rows[:limit] if limit else rows

    def cleanup(self) -> None:
        self.delete(list(self._entries.keys()))
        if self._arena is not None:
            try:
                self._arena_map.close()
                self._arena_file.close()
                self._arena.close()
                os.unlink(self._arena_path)
            except Exception:
                pass
            self._arena = None


# ---------------------------------------------------------------------------
# Client-side zero-copy views
# ---------------------------------------------------------------------------

# One shared read-write mapping per arena path per client process — this is
# plasma's "FD passing": every client shares the same physical pages.
_client_arenas: Dict[str, mmap.mmap] = {}
_client_arena_files: Dict[str, Any] = {}

_MADV_POPULATE_READ = 22   # Linux; absent from the mmap module's constants
_MADV_POPULATE_WRITE = 23
_POPULATE_MIN = 64 * 1024


def _populate(arena: mmap.mmap, offset: int, size: int, advice: int) -> None:
    """Fault an extent's pages into THIS process in one syscall: the store
    pre-commits tmpfs pages server-side, but each client mapping still pays
    a minor fault per page on first touch — ~5ms per 10 MiB if taken one by
    one inside memcpy, ~0.2ms batched here."""
    if size < _POPULATE_MIN:
        return
    start = offset & ~4095
    try:
        arena.madvise(advice, start, offset + size - start)
    except (OSError, ValueError):
        pass


def _client_arena_map(path: str) -> mmap.mmap:
    m = _client_arenas.get(path)
    if m is None:
        f = open(path, "r+b")
        m = mmap.mmap(f.fileno(), os.path.getsize(path))
        _client_arenas[path] = m
        _client_arena_files[path] = f
    return m


class MappedObject:
    """A client-side zero-copy view of a sealed store object.

    Plasma client-buffer semantics: the mapping holds a store-side
    client ref (the raylet will not spill/evict the extent under a live
    reader); when the last deserialized value sharing the buffer dies,
    ``close`` runs once and fires ``on_release`` so the worker tells the
    raylet to drop that ref. Without this, every restored object stayed
    reader-pinned forever and a small arena wedged with 'nothing
    spillable'."""

    __slots__ = ("_file", "_mmap", "_shared", "view", "on_release",
                 "_released", "__weakref__")

    def __init__(self, path: str, size: int, offset: int = 0,
                 on_release=None):
        self.on_release = on_release
        self._released = False
        if offset or os.path.basename(path).endswith("arena"):
            self._shared = True
            self._file = None
            self._mmap = None
            arena = _client_arena_map(path)
            _populate(arena, offset, size, _MADV_POPULATE_READ)
            self.view = memoryview(arena)[offset:offset + size]
            return
        self._shared = False
        self._file = open(path, "rb")
        if size > 0:
            self._mmap = mmap.mmap(self._file.fileno(), size,
                                   prot=mmap.PROT_READ)
            self.view = memoryview(self._mmap)
        else:
            self._mmap = None
            self.view = memoryview(b"")

    def close(self):
        try:
            self.view.release()
            if self._mmap is not None:
                self._mmap.close()
            if self._file is not None:
                self._file.close()
        except (BufferError, ValueError, OSError):
            pass
        cb, self.on_release = self.on_release, None
        if cb is not None and not self._released:
            self._released = True
            try:
                cb()
            except Exception:
                pass

    def mark_released(self) -> None:
        """The client ref is already being dropped elsewhere (bulk
        release at shutdown): suppress the per-object callback."""
        self._released = True
        self.on_release = None

    def __del__(self):
        self.close()


class WritableObject:
    """A client-side writable mapping used between create() and seal()."""

    __slots__ = ("_file", "_mmap", "_shared", "view")

    def __init__(self, path: str, size: int, offset: int = 0):
        if offset or os.path.basename(path).endswith("arena"):
            self._shared = True
            self._file = None
            self._mmap = None
            arena = _client_arena_map(path)
            _populate(arena, offset, size, _MADV_POPULATE_WRITE)
            self.view = memoryview(arena)[offset:offset + size]
            return
        self._shared = False
        self._file = open(path, "r+b")
        self._mmap = mmap.mmap(self._file.fileno(), size)
        self.view = memoryview(self._mmap)

    def close(self):
        try:
            self.view.release()
            if self._mmap is not None:
                self._mmap.close()
            if self._file is not None:
                self._file.close()
        except (BufferError, ValueError, OSError):
            pass
