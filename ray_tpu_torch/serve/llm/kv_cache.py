"""Paged KV-cache bookkeeping, the host side: the port's copy of the
jax-free ``ray_tpu/serve/llm/kv_cache.py``.

The device side lives in :mod:`ray_tpu_torch.models.llama`
(``init_paged_kv_cache`` allocates one pool of ``[block_size]``-row KV
blocks per layer; ``decode_step_paged``, ``verify_kv_paged`` and
``prefill_kv_paged`` read and write it through per-sequence *block
tables*). This module decides which physical block belongs to whom, and
which prompt prefixes are already resident so admission can skip their
prefill.

- :class:`BlockAllocator`: a fixed pool of ``num_blocks`` block ids with
  per-block reference counts. ``alloc`` hands out free ids or reports
  exhaustion (the engine queues the request; it never crashes);
  ``incref``/``free`` share blocks, and a block returns to the free list
  when its last reader releases it. ``copy_on_write`` gives a private id
  for a shared block about to be mutated (the engine shares only full
  prompt blocks and writes strictly past them, so it never needs the
  copy; the primitive is kept, and tested, as in the reference).
- :class:`PrefixCache`: reuse keyed on the hash of the token prefix at
  every block boundary (a hash chain). ``match`` walks the chain and
  increfs every hit block for the caller; ``insert`` registers a
  prompt's full blocks with cache-owned refs; LRU eviction frees the
  coldest entries when the allocator runs dry (PagedAttention,
  arXiv:2309.06180; SGLang's RadixAttention).
- :class:`KVTierManager`: the host-RAM tier below the device pool. An
  evicted prefix block is copied off the pool by the engine's spill hook
  and parked here (bounded by ``serve_kv_host_tier_bytes``); a later
  admission that misses the pool but hits the tier adopts the rows back
  when :class:`PromoteCostModel` says the copy beats recompute. The
  object-store tier below it (``put_fn``/``get_fn``) needs a cluster;
  the port's engine passes none, so host overflow is dropped and
  counted, as the reference does without a cluster.

One change from the reference: its block payloads are numpy arrays whose
bf16 type comes from ``ml_dtypes``; here ``k_blocks``/``v_blocks`` are
CPU ``torch.Tensor``s (``.shape``, ``.nbytes`` and slicing behave the
same). Everything else is the reference's code.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

__all__ = [
    "BlockAllocator", "KVPrefix", "KVState", "KVTierManager",
    "PrefixCache", "PromoteCostModel", "TierHit", "hash_prefix",
    "stable_hash_prefix",
]


@dataclass
class KVState:
    """A sequence's paged KV checkpoint, detached from any engine.

    `LLMEngine._export_state` copies the slot's live blocks into CPU
    tensors ([L, n_valid, bs, n_kv, hd]); admission adopts them back
    into a pool. Produced by batch-lane preemption (the checkpoint that
    lets a preempted decode resume) and by the disaggregated prefill
    tier (``disagg/prefill.py``), whose result a Serve router forwards
    to a decode replica through the object store.

    ``pos`` is the number of CONSUMED tokens — rows [0, pos) of the
    dense view are valid; ``next_tok`` is the last sampled token, not
    yet consumed (the engine's device ``tok`` at export time).
    ``tokens`` are the tokens already emitted to the caller (the first
    sampled token onward), so an adopting engine resumes max_tokens /
    stop accounting exactly where the exporter left off.
    """

    prompt: List[int]
    tokens: List[int]
    next_tok: int
    pos: int
    temperature: float
    block_size: int
    k_blocks: object        # CPU tensor [L, n_valid, bs, n_kv, hd]
    v_blocks: object

    @property
    def n_blocks(self) -> int:
        return int(self.k_blocks.shape[1])

    @property
    def payload_bytes(self) -> int:
        return int(self.k_blocks.nbytes + self.v_blocks.nbytes)

    def validate(self) -> None:
        bs = self.block_size
        need = -(-self.pos // bs)
        if self.n_blocks != need:
            raise ValueError(
                f"KVState holds {self.n_blocks} blocks but pos="
                f"{self.pos} at block_size={bs} needs {need}")
        if self.k_blocks.shape != self.v_blocks.shape:
            raise ValueError("k/v block shape mismatch")
        if not self.tokens or self.tokens[-1] != self.next_tok:
            raise ValueError(
                "next_tok must be the last emitted token (sampled but "
                "not yet consumed)")
        if self.pos != len(self.prompt) + len(self.tokens) - 1:
            raise ValueError(
                f"pos={self.pos} inconsistent with prompt "
                f"{len(self.prompt)} + emitted {len(self.tokens)} "
                f"(expected prompt + emitted - 1 consumed tokens)")


def hash_prefix(tokens: Sequence[int]) -> int:
    """Fast key for a token prefix. Python's tuple hash is salted per
    process (PYTHONHASHSEED) which is fine *locally* — each replica
    owns its pool, so its prefix cache is process-local. Anything that
    crosses processes (the cluster-wide prefix index, the GCS
    ``report/lookup_prefix_index`` RPCs) must use
    :func:`stable_hash_prefix` instead."""
    return hash(tuple(tokens))


def stable_hash_prefix(tokens: Sequence[int]) -> int:
    """Process-independent key for a token prefix — the hash that may
    cross the wire. crc32 over the little-endian token stream: cheap,
    deterministic everywhere, and collisions only cost a wasted peer
    probe (every consumer re-verifies against real tokens before
    trusting a match)."""
    import numpy as np

    return int(zlib.crc32(
        np.asarray(tokens, np.int64).tobytes()))


class BlockAllocator:
    """Fixed pool of ``num_blocks`` KV blocks with refcounts.

    Thread-safe: the engine's scheduler thread allocates while the
    dashboard thread reads stats. All ops are O(1) amortized.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 block_bytes: int = 0):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(
                f"need positive num_blocks/block_size, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # HBM bytes per block (k + v rows across all layers); 0 when
        # the caller doesn't care about byte-level accounting.
        self.block_bytes = int(block_bytes)
        self._free: deque = deque(range(num_blocks))
        self._refs: List[int] = [0] * num_blocks
        self._lock = threading.Lock()

    # -- core ------------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None if the pool can't cover
        it (caller queues / evicts; nothing is partially allocated)."""
        with self._lock:
            if n > len(self._free):
                return None
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._refs[b] = 1
            return out

    def incref(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                if self._refs[b] <= 0:
                    raise ValueError(f"incref on free block {b}")
                self._refs[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per id; blocks hitting 0 rejoin the pool."""
        with self._lock:
            for b in blocks:
                r = self._refs[b] - 1
                if r < 0:
                    raise ValueError(f"double free of block {b}")
                self._refs[b] = r
                if r == 0:
                    self._free.append(b)

    def fork(self, blocks: Sequence[int]) -> List[int]:
        """Share an existing table (copy-on-write fork): the child holds
        the same physical ids, each with one more reference."""
        self.incref(blocks)
        return list(blocks)

    def copy_on_write(self, block: int) -> Tuple[int, bool]:
        """Prepare ``block`` for mutation. Uniquely-owned blocks are
        returned as-is; shared ones release one ref and return a fresh
        private id (returns (id, needs_copy) — the caller must copy the
        HBM rows when needs_copy). None is never returned: raises on
        exhaustion so callers treat COW pressure as a hard signal."""
        with self._lock:
            if self._refs[block] <= 0:
                raise ValueError(f"copy_on_write on free block {block}")
            if self._refs[block] == 1:
                return block, False
            if not self._free:
                raise MemoryError(
                    "copy_on_write: pool exhausted (free a sequence or "
                    "evict prefix-cache entries first)")
            new = self._free.popleft()
            self._refs[new] = 1
            self._refs[block] -= 1
            return new, True

    # -- migration -------------------------------------------------------
    def adopt(self, n: int,
              prefix_cache: Optional["PrefixCache"] = None
              ) -> Optional[List[int]]:
        """All-or-nothing allocation for an imported/resumed sequence:
        like :meth:`alloc`, but under pressure it first evicts cold
        prefix-cache entries to make room (the same fallback admission
        uses). Returns None — nothing allocated, nothing evicted beyond
        the attempt — when the pool still can't cover ``n``; the caller
        requeues the import and retries as running sequences finish."""
        blocks = self.alloc(n)
        if blocks is None and prefix_cache is not None:
            prefix_cache.evict(n - self.free_blocks)
            blocks = self.alloc(n)
        return blocks

    def donate(self, blocks: Sequence[int]) -> None:
        """Release a live sequence's block refs after its KV has been
        exported (the ownership hand-off half of a migration: the rows
        now live in a :class:`KVState` / another engine's pool, so this
        engine's copies may be recycled). Identical accounting to
        :meth:`free` — the name records intent at export sites, and the
        liveness check catches exporting an already-freed slot."""
        for b in blocks:
            if self.refcount(b) <= 0:
                raise ValueError(
                    f"donate of free block {b}: export must happen "
                    f"before the slot is torn down")
        self.free(blocks)

    # -- introspection ---------------------------------------------------
    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs[block]

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def used_bytes(self) -> int:
        return self.used_blocks * self.block_bytes

    @property
    def free_bytes(self) -> int:
        return self.free_blocks * self.block_bytes

    def stats(self) -> Dict[str, int]:
        return {
            "num_blocks": self.num_blocks,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "block_bytes": self.block_bytes,
            "used_bytes": self.used_bytes,
            "free_bytes": self.free_bytes,
        }


@dataclass
class _Entry:
    """One full block of one cached prefix: the chain link at block
    boundary ``depth`` (prefix length = depth * block_size).

    ``tokens`` is the full covered prefix — needed so an evicted entry
    can be spilled down a tier under a key the next admission (or a
    peer replica, via the stable hash) can still resolve, and so tier
    hits verify against real tokens instead of trusting a hash."""
    block: int
    depth: int
    tokens: Tuple[int, ...] = ()
    _stable: Optional[int] = None

    @property
    def stable(self) -> int:
        if self._stable is None:
            self._stable = stable_hash_prefix(self.tokens)
        return self._stable


class PrefixCache:
    """Block-granular prompt-prefix reuse over a :class:`BlockAllocator`.

    Entries are keyed ``hash(tokens[: j * block_size])`` for j = 1..;
    each holds exactly one cache-owned reference on one block. ``match``
    walks j upward until the first miss — the hit blocks cover positions
    ``[0, hits * block_size)`` and arrive *increffed for the caller*
    (the engine later frees them with the rest of the sequence's table,
    no special-casing). Eviction pops least-recently-matched entries;
    an entry's block only truly returns to the pool once every sequence
    still reading it has also released it — refcounts make eviction safe
    mid-flight.
    """

    def __init__(self, allocator: BlockAllocator,
                 max_blocks: Optional[int] = None):
        self.allocator = allocator
        self.max_blocks = (allocator.num_blocks if max_blocks is None
                           else max_blocks)
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0            # match() calls that found >= 1 block
        self.misses = 0
        self.hit_tokens = 0      # positions whose prefill was skipped
        self.hit_bytes = 0       # HBM bytes those positions occupy
        self.evictions = 0       # entries evicted (≈ blocks released)
        self.evicted_bytes = 0
        self.spilled = 0         # evicted blocks handed to spill_fn
        self.spilled_bytes = 0
        self.spill_errors = 0
        # Engine-installed eviction hook: called with the victim
        # ``_Entry`` list while their blocks STILL hold the cache ref
        # (the HBM rows are valid until the ``allocator.free`` that
        # follows). Returns how many blocks it actually spilled.
        self.spill_fn: Optional[Callable[[List[_Entry]], int]] = None

    def __len__(self) -> int:
        return len(self._entries)

    # -- lookup ----------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_blocks: Optional[int] = None) -> List[int]:
        """Longest cached block-chain covering a prefix of ``tokens``.

        Returns the physical block ids (may be empty), each increffed on
        behalf of the caller. ``max_blocks`` caps the hit (the engine
        passes ``(len(prompt) - 1) // block_size`` so at least the last
        prompt token is always prefilled — its logits seed sampling)."""
        bs = self.allocator.block_size
        limit = len(tokens) // bs
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        out: List[int] = []
        with self._lock:
            for j in range(1, limit + 1):
                e = self._entries.get(hash_prefix(tokens[: j * bs]))
                if e is None or e.depth != j:
                    break
                out.append(e.block)
                self._entries.move_to_end(hash_prefix(tokens[: j * bs]))
            if out:
                self.hits += 1
                self.hit_tokens += len(out) * bs
                self.hit_bytes += len(out) * self.allocator.block_bytes
            else:
                self.misses += 1
        if out:
            self.allocator.incref(out)
        return out

    # -- registration ----------------------------------------------------
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        """Register a prompt's resident full blocks. ``blocks[j]`` must
        hold the KV rows for positions ``[j*bs, (j+1)*bs)`` of
        ``tokens``. Already-cached depths are skipped (the shared block
        is already registered); new depths take one cache-owned ref."""
        bs = self.allocator.block_size
        n = min(len(tokens) // bs, len(blocks))
        fresh: List[Tuple[int, _Entry]] = []
        with self._lock:
            for j in range(1, n + 1):
                key = hash_prefix(tokens[: j * bs])
                if key in self._entries:
                    self._entries.move_to_end(key)
                    continue
                fresh.append((key, _Entry(block=blocks[j - 1], depth=j,
                                          tokens=tuple(tokens[: j * bs]))))
        if not fresh:
            return
        self.allocator.incref([e.block for _, e in fresh])
        with self._lock:
            for key, e in fresh:
                if key in self._entries:       # lost a race: drop our ref
                    self.allocator.free([e.block])
                    continue
                self._entries[key] = e
            overflow = len(self._entries) - self.max_blocks
        if overflow > 0:
            self.evict(overflow)

    # -- eviction --------------------------------------------------------
    def evict(self, n_blocks: int) -> int:
        """Release the ``n_blocks`` least-recently-matched entries'
        cache refs (deepest-first within equal recency, so a chain's
        tail goes before its root and surviving prefixes stay usable).
        Returns how many refs were dropped; the pool only grows by the
        blocks nobody else still reads.

        If the engine installed :attr:`spill_fn`, the victims are
        offered to it *before* their refs drop — at that point the
        cache still owns the blocks, so the hook may gather their HBM
        rows and park them in a lower tier. Spill failures are counted
        and never block the eviction itself (the pool must grow)."""
        victims: List[_Entry] = []
        with self._lock:
            # LRU order with chain-tail preference: scan from coldest,
            # take deepest entries first among the same prefix family.
            while len(victims) < n_blocks and self._entries:
                # coldest key
                key = next(iter(self._entries))
                victims.append(self._entries.pop(key))
                self.evictions += 1
        if not victims:
            return 0
        self.evicted_bytes += len(victims) * self.allocator.block_bytes
        if self.spill_fn is not None:
            try:
                n = int(self.spill_fn(victims))
                self.spilled += n
                self.spilled_bytes += n * self.allocator.block_bytes
            except Exception:
                self.spill_errors += 1
        self.allocator.free([e.block for e in victims])
        return len(victims)

    def clear(self) -> None:
        self.evict(len(self._entries))

    def snapshot_heads(self, max_heads: int = 512) -> List[Tuple[int, int]]:
        """Hottest cached chain links as ``(stable_hash, depth)`` pairs,
        most-recently-matched first — what a replica publishes to the
        cluster-wide prefix index. Uses :func:`stable_hash_prefix` so
        peers can compare against their own prompts; entries inserted
        without tokens (pre-tiering callers) are skipped."""
        with self._lock:
            entries = [e for e in reversed(self._entries.values())
                       if e.tokens][:max_heads]
        return [(e.stable, e.depth) for e in entries]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "hit_bytes": self.hit_bytes,
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "spilled": self.spilled,
                "spilled_bytes": self.spilled_bytes,
                "spill_errors": self.spill_errors,
            }


@dataclass
class KVPrefix:
    """One spilled prefix block, detached from any pool.

    The tier-resident sibling of :class:`KVState`: where KVState
    checkpoints a *live sequence* (sampling state, emitted tokens),
    KVPrefix carries only the KV rows of full prompt blocks — no
    ``next_tok``/``pos`` semantics, because a promoted prefix re-enters
    through admission, not through resume. ``tokens`` is the full
    covered prefix; the payload holds its LAST ``n_blocks`` blocks
    (spilled chain links carry one block each — the earlier links are
    their own entries), and doubles as the collision check for
    hash-keyed tier lookups. The payload is CPU tensors.
    """

    tokens: Tuple[int, ...]
    block_size: int
    k_blocks: object        # CPU tensor [L, n_blocks, bs, n_kv, hd]
    v_blocks: object

    @property
    def n_blocks(self) -> int:
        return int(self.k_blocks.shape[1])

    @property
    def payload_bytes(self) -> int:
        return int(self.k_blocks.nbytes + self.v_blocks.nbytes)

    def validate(self) -> None:
        if not self.tokens or len(self.tokens) % self.block_size:
            raise ValueError(
                f"KVPrefix must cover whole blocks, got "
                f"{len(self.tokens)} tokens at block_size "
                f"{self.block_size}")
        if self.n_blocks * self.block_size > len(self.tokens):
            raise ValueError(
                f"KVPrefix holds {self.n_blocks} blocks but the "
                f"covered prefix is only {len(self.tokens)} tokens")
        if self.k_blocks.shape != self.v_blocks.shape:
            raise ValueError("k/v block shape mismatch")


@dataclass
class PromoteCostModel:
    """Is the scatter cheaper than the recompute?

    Promoting n tier blocks back into HBM costs a fixed dispatch (host
    staging + one `_adopt_fn` launch) plus a per-block transfer;
    recomputing costs prefill over the covered tokens. Short suffixes
    lose to recompute — prefill is one fused program and the fixed
    adopt cost dominates — so admission only promotes when the model
    says the crossover is passed. Defaults come from the
    ``serve_kv_adopt_cost_*`` / ``serve_kv_prefill_cost_per_token_ms``
    config knobs; benches overwrite them with measured numbers.
    """

    adopt_fixed_s: float = 2e-3
    adopt_per_block_s: float = 1e-4
    prefill_per_token_s: float = 5e-5

    def promote_cost_s(self, n_blocks: int) -> float:
        return self.adopt_fixed_s + n_blocks * self.adopt_per_block_s

    def recompute_cost_s(self, n_tokens: int) -> float:
        return n_tokens * self.prefill_per_token_s

    def should_promote(self, n_blocks: int, block_size: int) -> bool:
        return (self.promote_cost_s(n_blocks)
                < self.recompute_cost_s(n_blocks * block_size))


@dataclass
class TierHit:
    """One tier-lookup result: where ``prefix`` was found and under
    which key, so a successful promote can :meth:`KVTierManager.pop`
    exactly what it consumed (all-or-nothing: nothing is popped until
    the scatter landed)."""
    key: int
    tier: str
    prefix: KVPrefix


class KVTierManager:
    """Host-RAM + object-store tiers below the HBM block pool.

    Spilled blocks land in an LRU host dict bounded by
    ``host_budget_bytes``; overflow demotes the coldest entries to the
    object store via ``put_fn`` when a cluster is
    attached, else drops them (counted — a dropped block just means a
    future recompute, never an error). ``lookup`` extends an HBM
    partial hit with the longest contiguous tier run; ``pop`` commits
    consumption after the engine's scatter succeeded.

    Keys are process-local :func:`hash_prefix` values — the manager
    lives and dies with its engine. What crosses processes is the
    *stable* hash (:meth:`stable_heads`, the cluster index) and the
    KVPrefix payloads themselves (peer pull), both of which re-verify
    against real tokens here before anything is trusted.

    Thread-safe: the engine scheduler spills/promotes while dashboard
    and publisher threads read stats/heads.
    """

    TIERS = ("host", "store")

    def __init__(self, host_budget_bytes: int, block_size: int = 16,
                 put_fn: Optional[Callable[[Any], Any]] = None,
                 get_fn: Optional[Callable[[Any], Any]] = None):
        self.host_budget_bytes = int(host_budget_bytes)
        self.block_size = int(block_size)
        self.put_fn = put_fn
        self.get_fn = get_fn
        self._host: "OrderedDict[int, KVPrefix]" = OrderedDict()
        self._store: "OrderedDict[int, Tuple[Any, Tuple[int, ...], int]]" \
            = OrderedDict()          # key -> (ref, tokens, payload_bytes)
        self._host_bytes = 0
        self._store_bytes = 0
        self._lock = threading.Lock()
        self._c = {t: {"hits": 0, "misses": 0, "spills": 0,
                       "promotes": 0} for t in self.TIERS}
        self.dropped_blocks = 0
        self.dropped_bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._host) + len(self._store)

    # -- spill (HBM -> host -> store) ------------------------------------
    def spill(self, prefixes: Sequence[KVPrefix]) -> int:
        """Park evicted blocks in the host tier (newest hottest),
        demoting over-budget cold entries downward. Returns how many of
        ``prefixes`` were accepted (all, unless a prefix fails
        validation)."""
        n = 0
        for p in prefixes:
            try:
                p.validate()
            except (ValueError, AttributeError):
                continue
            key = hash_prefix(p.tokens)
            with self._lock:
                old = self._host.pop(key, None)
                if old is not None:
                    self._host_bytes -= old.payload_bytes
                self._host[key] = p
                self._host_bytes += p.payload_bytes
                self._c["host"]["spills"] += 1
                n += 1
        self._demote_overflow()
        return n

    def _demote_overflow(self) -> None:
        """Push the coldest host entries down until under budget."""
        while True:
            with self._lock:
                if self._host_bytes <= self.host_budget_bytes \
                        or not self._host:
                    return
                key, p = self._host.popitem(last=False)
                self._host_bytes -= p.payload_bytes
            if self.put_fn is None:
                with self._lock:
                    self.dropped_blocks += p.n_blocks
                    self.dropped_bytes += p.payload_bytes
                continue
            try:
                ref = self.put_fn(p)
            except Exception:
                with self._lock:
                    self.dropped_blocks += p.n_blocks
                    self.dropped_bytes += p.payload_bytes
                continue
            with self._lock:
                self._store[key] = (ref, p.tokens, p.payload_bytes)
                self._store_bytes += p.payload_bytes
                self._c["store"]["spills"] += 1

    # -- lookup (promote candidates) -------------------------------------
    def lookup(self, tokens: Sequence[int], block_size: int,
               start_depth: int = 0,
               max_blocks: Optional[int] = None) -> List[TierHit]:
        """Longest contiguous tier run continuing ``tokens`` from block
        boundary ``start_depth`` (the HBM hit depth). Walks depths
        upward, host tier first, resolving store refs through
        ``get_fn``; every hit is token-verified. Entries stay resident —
        call :meth:`pop` only after the promote scatter landed."""
        limit = len(tokens) // block_size
        if max_blocks is not None:
            limit = min(limit, start_depth + max_blocks)
        hits: List[TierHit] = []
        for j in range(start_depth + 1, limit + 1):
            want = tuple(tokens[: j * block_size])
            key = hash_prefix(want)
            hit = self._lookup_one(key, want)
            if hit is None:
                break
            hits.append(hit)
        return hits

    def _lookup_one(self, key: int,
                    want: Tuple[int, ...]) -> Optional[TierHit]:
        with self._lock:
            p = self._host.get(key)
            if p is not None and p.tokens == want:
                self._host.move_to_end(key)
                self._c["host"]["hits"] += 1
                return TierHit(key=key, tier="host", prefix=p)
            self._c["host"]["misses"] += 1
            entry = self._store.get(key)
        if entry is None or self.get_fn is None:
            with self._lock:
                self._c["store"]["misses"] += 1
            return None
        ref, tok, _ = entry
        if tok != want:
            with self._lock:
                self._c["store"]["misses"] += 1
            return None
        try:
            p = self.get_fn(ref)
        except Exception:
            p = None
        if p is None or tuple(p.tokens) != want:
            with self._lock:
                self._c["store"]["misses"] += 1
            return None
        with self._lock:
            self._c["store"]["hits"] += 1
        return TierHit(key=key, tier="store", prefix=p)

    def pop(self, hits: Sequence[TierHit]) -> None:
        """Commit consumption of promoted entries: drop them from their
        tier (a promoted block is HBM-resident again and re-enters the
        PrefixCache via the normal insert path — keeping the tier copy
        would double-count the budget)."""
        with self._lock:
            for h in hits:
                p = self._host.pop(h.key, None)
                if p is not None:
                    self._host_bytes -= p.payload_bytes
                    self._c["host"]["promotes"] += 1
                    continue
                entry = self._store.pop(h.key, None)
                if entry is not None:
                    self._store_bytes -= entry[2]
                    self._c["store"]["promotes"] += 1

    # -- cluster index ---------------------------------------------------
    def stable_heads(self, max_heads: int = 512) -> List[Tuple[int, int]]:
        """Tier-resident chain links as ``(stable_hash, depth)`` pairs,
        hottest first — merged with :meth:`PrefixCache.snapshot_heads`
        into the replica's published index entry."""
        toks: List[Tuple[int, ...]] = []
        with self._lock:
            for p in reversed(self._host.values()):
                if len(toks) >= max_heads:
                    break
                toks.append(p.tokens)
            for _, tok, _ in reversed(self._store.values()):
                if len(toks) >= max_heads:
                    break
                toks.append(tok)
        return [(stable_hash_prefix(t), len(t) // self.block_size)
                for t in toks]

    def clear(self) -> None:
        with self._lock:
            self._host.clear()
            self._store.clear()
            self._host_bytes = self._store_bytes = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "host": dict(self._c["host"], blocks=len(self._host),
                             bytes=self._host_bytes,
                             budget_bytes=self.host_budget_bytes),
                "store": dict(self._c["store"], blocks=len(self._store),
                              bytes=self._store_bytes),
                "dropped_blocks": self.dropped_blocks,
                "dropped_bytes": self.dropped_bytes,
            }
