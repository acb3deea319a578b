"""Owner-side reference counting + object directory + borrower protocol.

Role-equivalent to the reference's distributed ref counter and
ownership-based object directory (`reference_count.h:61`,
`reference_count.cc`, `ownership_based_object_directory.h`): the worker
that created an object is its *owner*; it tracks (a) local Python refs,
(b) pending submitted tasks that depend on the object, (c) *borrowers* —
remote workers or containing objects that hold the ref after it was
serialized out, and (d) the set of nodes holding a sealed copy. When all
counts drain the object is freed everywhere via the on_free callback.

Borrower protocol (the re-designed analogue of borrowed refs /
WaitForRefRemoved in `reference_count.cc`):

* Serializing a ref out adds a *pending share* — a TTL-stamped pin that
  keeps the object alive while the bytes are in flight to a recipient
  nobody has identified yet.
* A recipient that deserializes the ref registers itself as a borrower
  with the owner (worker-keyed), consuming one pending share. For task
  args this happens before the task body runs, while the caller still
  holds the task-dependency pin — so registration is race-free.
* A ref serialized *inside* another object registers an object-keyed
  borrower (``obj:<outer-id>``) held until the outer object is freed;
  the owner of the outer object releases it (nested refs).
* A borrower whose local refs drain sends release_borrower to the owner
  and drops its entry. Dead borrowers are reaped by the owner's liveness
  sweep; unconsumed pending shares expire after a TTL (config
  ``borrow_pending_ttl_s``) — the backstop that turns every lost-message
  race into a bounded delay instead of a permanent pin (the round-3
  design pinned every serialized-out ref forever).

Pure, lock-guarded state machine — tested standalone like
`reference_count_test.cc` does; all RPC happens in callbacks installed by
the worker.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple


@dataclass(slots=True)
class _Ref:
    local: int = 0
    task_deps: int = 0
    # Monotonic timestamps of serialize-outs not yet claimed by a
    # borrower registration; expired by the TTL sweep.
    pending_shares: List[float] = field(default_factory=list)
    # borrower key -> addr tuple (worker borrowers) or None (object-keyed
    # holders and local-process keys; never pinged).
    borrowers: Dict[bytes, Optional[Tuple[str, int]]] = field(
        default_factory=dict)
    freed: bool = False
    locations: Set[bytes] = field(default_factory=set)
    is_owned_by_us: bool = True
    # Borrower-side bookkeeping: the owner's address (for the release
    # RPC) and whether the release was already emitted.
    owner_addr: Optional[Tuple[str, int]] = None
    released: bool = False


class ReferenceCounter:
    def __init__(
        self,
        on_free: Optional[Callable[[bytes, Set[bytes]], None]] = None,
        on_borrow_release: Optional[
            Callable[[bytes, Tuple[str, int]], None]] = None,
        on_contained_free: Optional[
            Callable[[bytes, List[Tuple[bytes, Optional[Tuple[str, int]]]]],
                     None]] = None,
    ):
        self._refs: Dict[bytes, _Ref] = {}
        # Side index: oids that currently have >=1 pending share. The TTL
        # sweep walks ONLY this set — walking the full _refs table under
        # the lock stalls every add_owned/add_local_ref caller for the
        # whole scan once the table reaches millions of entries (observed
        # as 180 s suite wedges inside add_owned).
        self._with_pending: Set[bytes] = set()
        # Freed-object tombstones: get() distinguishes "freed by owner"
        # from "unknown" via is_freed, but keeping whole _Ref objects for
        # every dead ref grows the heap without bound (a long suite run
        # spent its time in multi-second GC pauses over millions of dead
        # entries). Bounded id set instead.
        self._freed_ids: "OrderedDict[bytes, None]" = OrderedDict()
        self._freed_cap = 200_000
        # outer object id -> [(inner oid, inner owner addr or None=ours)]
        self._contained: Dict[bytes, List[Tuple[bytes, Optional[Tuple]]]] = {}
        self._lock = threading.RLock()
        self._on_free = on_free
        # Borrower side: our last ref on a borrowed object drained — tell
        # the owner at `addr` that we no longer hold `oid`.
        self._on_borrow_release = on_borrow_release
        # Owner side: a freed outer object contained refs owned elsewhere —
        # release our object-keyed borrow with their owners.
        self._on_contained_free = on_contained_free

    # -- ref lifecycle ------------------------------------------------------
    def _live(self, object_id: bytes) -> Optional[_Ref]:
        """Entry for a NOT-freed object, creating if new. None when the
        id is tombstoned — a late-arriving ref copy must never resurrect
        a freed object (that would re-fire on_free and double-release)."""
        if object_id in self._freed_ids:
            return None
        return self._refs.setdefault(object_id, _Ref())

    def add_owned(self, object_id: bytes) -> None:
        with self._lock:
            self._live(object_id)

    def add_borrowed(self, object_id: bytes,
                     owner_addr: Optional[Tuple[str, int]] = None) -> None:
        with self._lock:
            ref = self._live(object_id)
            if ref is None:
                return
            ref.is_owned_by_us = False
            if owner_addr is not None:
                ref.owner_addr = tuple(owner_addr)

    def add_local_ref(self, object_id: bytes) -> None:
        with self._lock:
            ref = self._live(object_id)
            if ref is not None:
                ref.local += 1

    def remove_local_ref(self, object_id: bytes) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.local = max(0, ref.local - 1)
            self._maybe_free(object_id, ref)

    def add_task_dependency(self, object_id: bytes) -> None:
        with self._lock:
            ref = self._live(object_id)
            if ref is not None:
                ref.task_deps += 1

    def remove_task_dependency(self, object_id: bytes) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.task_deps = max(0, ref.task_deps - 1)
            self._maybe_free(object_id, ref)

    # -- borrower protocol --------------------------------------------------
    def add_pending_share(self, object_id: bytes) -> None:
        """The ref was serialized out: pin until a recipient registers as
        a borrower or the TTL sweep expires the share."""
        with self._lock:
            ref = self._live(object_id)
            if ref is not None:
                ref.pending_shares.append(time.monotonic())
                self._with_pending.add(object_id)

    # Compatibility alias (round-3 name, thin-client path).
    mark_shared = add_pending_share

    def consume_pending_share(self, object_id: bytes) -> None:
        """The serialized bytes came back to this process (the recipient
        is us): the in-flight pin is no longer needed."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None or not ref.pending_shares:
                return
            ref.pending_shares.pop(0)
            if not ref.pending_shares:
                self._with_pending.discard(object_id)
            self._maybe_free(object_id, ref)

    def register_borrower(self, object_id: bytes, key: bytes,
                          addr: Optional[Tuple[str, int]] = None) -> bool:
        """A remote worker (or a containing object) now holds this ref.
        Consumes one pending share. Returns False if the object is
        already freed (late registration — the borrower's ref dangles)."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None or ref.freed:
                return False
            if key in ref.borrowers:
                return True  # duplicate registration (RPC retry): no-op
            ref.borrowers[key] = tuple(addr) if addr else None
            if ref.pending_shares:
                ref.pending_shares.pop(0)
                if not ref.pending_shares:
                    self._with_pending.discard(object_id)
            return True

    def release_borrower(self, object_id: bytes, key: bytes) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.borrowers.pop(key, None)
            self._maybe_free(object_id, ref)

    def set_contained(self, outer_id: bytes,
                      inners: List[Tuple[bytes, Optional[Tuple]]]) -> None:
        """Record that the sealed value of `outer_id` embeds `inners`
        (oid, owner_addr-or-None-for-ours). Owner-side holders for inners
        we own must be registered separately (object-keyed borrower)."""
        if not inners:
            return
        with self._lock:
            self._contained.setdefault(outer_id, []).extend(inners)

    def expire_pending(self, ttl_s: float) -> None:
        """Drop pending shares older than ttl_s (lost messages, crashed
        recipients); frees objects whose last pin this was."""
        cutoff = time.monotonic() - ttl_s
        with self._lock:
            candidates = list(self._with_pending)
        # Chunked re-acquire: the sweep must never hold the lock long
        # enough to stall foreground add_owned/add_local_ref callers.
        for i in range(0, len(candidates), 512):
            with self._lock:
                for oid in candidates[i:i + 512]:
                    ref = self._refs.get(oid)
                    if ref is None or not ref.pending_shares:
                        self._with_pending.discard(oid)
                        continue
                    ref.pending_shares = [t for t in ref.pending_shares
                                          if t >= cutoff]
                    if not ref.pending_shares:
                        self._with_pending.discard(oid)
                    self._maybe_free(oid, ref)

    def borrower_addrs(self) -> Dict[Tuple[str, int], List[Tuple[bytes, bytes]]]:
        """addr -> [(object_id, borrower_key)] for every worker-keyed
        borrower; the owner's liveness sweep pings these."""
        out: Dict[Tuple[str, int], List[Tuple[bytes, bytes]]] = {}
        with self._lock:
            for oid, ref in self._refs.items():
                if ref.freed:
                    continue
                for key, addr in ref.borrowers.items():
                    if addr is not None:
                        out.setdefault(addr, []).append((oid, key))
        return out

    # -- directory ----------------------------------------------------------
    def add_location(self, object_id: bytes, node_id: bytes) -> None:
        with self._lock:
            ref = self._live(object_id)
            if ref is not None:
                ref.locations.add(node_id)

    def remove_location(self, object_id: bytes, node_id: bytes) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None:
                ref.locations.discard(node_id)

    def locations(self, object_id: bytes) -> Set[bytes]:
        with self._lock:
            ref = self._refs.get(object_id)
            return set(ref.locations) if ref else set()

    # -- queries ------------------------------------------------------------
    def has_ref(self, object_id: bytes) -> bool:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref is not None and not ref.freed

    def is_freed(self, object_id: bytes) -> bool:
        with self._lock:
            if object_id in self._freed_ids:
                return True
            ref = self._refs.get(object_id)
            return ref is not None and ref.freed

    def is_borrowed(self, object_id: bytes) -> bool:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref is not None and not ref.is_owned_by_us

    def num_tracked(self) -> int:
        with self._lock:
            return sum(1 for r in self._refs.values() if not r.freed)

    def snapshot(self, object_id: bytes) -> Optional[dict]:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return None
            return {"local": ref.local, "task_deps": ref.task_deps,
                    "pending_shares": len(ref.pending_shares),
                    "borrowers": set(ref.borrowers),
                    "freed": ref.freed,
                    "locations": set(ref.locations),
                    "is_owned_by_us": ref.is_owned_by_us}

    # -- freeing ------------------------------------------------------------
    def _maybe_free(self, object_id: bytes, ref: _Ref) -> None:
        """Caller must hold the lock."""
        if (ref.local or ref.task_deps or ref.pending_shares
                or ref.borrowers or ref.freed):
            return
        if ref.is_owned_by_us:
            locations = set(ref.locations)
            contained = self._contained.pop(object_id, None)
            self._tombstone(object_id)
            if self._on_free is not None:
                self._on_free(object_id, locations)
            if contained and self._on_contained_free is not None:
                self._on_contained_free(object_id, contained)
        else:
            # Borrower side: our last hold drained — tell the owner once
            # and forget the entry (a re-borrow recreates it).
            if ref.released:
                return
            ref.released = True
            addr = ref.owner_addr
            del self._refs[object_id]
            self._with_pending.discard(object_id)
            if addr is not None and self._on_borrow_release is not None:
                self._on_borrow_release(object_id, addr)

    def drain_borrows(self) -> List[Tuple[bytes, Tuple[str, int]]]:
        """Worker exit: every borrowed entry still alive, for a best-
        effort bulk release."""
        out = []
        with self._lock:
            for oid, ref in list(self._refs.items()):
                if (not ref.is_owned_by_us and not ref.released
                        and ref.owner_addr is not None):
                    ref.released = True
                    out.append((oid, ref.owner_addr))
        return out

    def _tombstone(self, object_id: bytes) -> None:
        """Caller holds the lock: drop the _Ref, remember just the id."""
        self._refs.pop(object_id, None)
        self._with_pending.discard(object_id)
        self._freed_ids[object_id] = None
        while len(self._freed_ids) > self._freed_cap:
            self._freed_ids.popitem(last=False)

    def clear(self) -> None:
        """Worker shutdown: release the whole graph promptly (GC over a
        dead worker's millions of entries otherwise dominates teardown)."""
        with self._lock:
            self._refs.clear()
            self._with_pending.clear()
            self._contained.clear()
            self._freed_ids.clear()

    def force_free(self, object_id: bytes) -> None:
        """Explicit free (`ray_tpu_torch.internal.free`) regardless of counts."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None or ref.freed:
                return
            locations = set(ref.locations)
            contained = self._contained.pop(object_id, None)
            self._tombstone(object_id)
            if self._on_free is not None:
                self._on_free(object_id, locations)
            if contained and self._on_contained_free is not None:
                self._on_contained_free(object_id, contained)
