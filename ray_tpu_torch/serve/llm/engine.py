"""Continuous-batching LLM engine: the PyTorch counterpart of
``ray_tpu/serve/llm/engine.py``, dense and paged KV layouts, with
speculative decoding on the paged one.

- A fixed pool of ``B = num_slots`` decode slots. Dense layout: one KV
  cache ``[L, B, S, n_kv, head_dim]`` on the device, a stripe per slot.
  Paged layout: one pool of ``[kv_block_size]``-row blocks shared by all
  slots through per-slot block tables (``kv_cache.BlockAllocator``), so
  short requests stop reserving ``S`` rows, and a prefix cache
  (``kv_cache.PrefixCache``) skips the prefill of prompt prefixes that
  are already resident.
- One decode tick advances every live slot together
  (``models.llama.decode_step`` / ``decode_step_paged`` with the
  slot-active mask: dead slots ride through the batch but write nothing
  the live ones read), ``decode_block`` steps per tick.
- Prefill runs at a small set of padded prompt-length buckets. Dense:
  the prompt's KV lands at the slot's stripe; with ``attn_impl="flash"``
  and buckets of at least 128 tokens every prefill goes through the
  flash kernel, once per layer. Paged: the suffix after a prefix hit is
  prefilled over the slot's gathered history with plain attention (as
  in the reference) and scattered into fresh blocks.
- Slot eviction and recycling are host-side bookkeeping: EOS, a stop
  token or ``max_tokens`` free the slot and the next queued request
  prefills into it. Stale KV past a recycled slot's position is
  harmless: decode masks positions > pos and writes each position before
  it attends to it.

Paged extras, all from the reference: chunked prefill of prompts longer
than the largest bucket (bucket-sized chunks through the prefix cache,
one chunk per scheduler step); a host-RAM KV tier below the pool
(``kv_cache.KVTierManager``: prefix-cache evictions spill there, and
re-admissions promote them back when ``PromoteCostModel`` favours the
copy over recompute); batch-lane preemption (an interactive request that
cannot be admitted checkpoints the newest batch decode through
``_export_state``; it resumes through the adopt path, token for token);
and speculative decoding (``draft_params``: a small draft proposes
``spec_k - 1`` greedy tokens from its dense cache, one
``verify_kv_paged`` call scores them, and the longest agreeing prefix is
accepted, so the tokens are the plain tick's). The draft's prefill goes
through ``prefill_kv``, so under ``attn_impl="flash"`` at buckets of at
least 128 it runs the flash kernel too.

The reference's compiled programs donate their buffers; here the
scheduler thread updates the cache and the token/position tensors in
place. Only that thread touches device state: ``submit`` and ``cancel``
(any thread) only queue work under the lock. The reference pads block
ids with ``pool_blocks`` and relies on XLA dropping out-of-bounds
scatters; here inactive rows write the pool's sink block
(``models.llama.init_paged_kv_cache``), and the adopt copy takes exactly
the valid blocks.

Greedy decoding is token-identical to ``models.llama.generate`` on the
same params: bucket padding sits after the prompt, attention is causal,
and the first token comes from the logits at row ``prompt_len - 1``.

The disaggregated tier, from the reference: ``Request.prefill_only``
finishes a request at its first token as ``"prefill"`` with its KV
exported onto the handle (``handle.kv_state``), and ``submit_adopted``
queues a request whose prefill ran elsewhere, which admission adopts as
it adopts a preempted checkpoint (``_admit_adopted``). A peer prefix pull
goes through ``export_prefix`` (on the scheduler thread, through
``call_on_scheduler``) and ``import_prefix`` (into the host tier, whose
promote path takes it from there); ``prefix_index_heads`` lists what a
replica can serve without prefilling.

The reference's observability hooks: serve metrics
(``observability.serve``; ``_update_gauges`` reads host state only, so
they add no device sync), request spans (``llm.queued``,
``llm.prefill``, ``llm.decode``, ``llm.request``, ``kv.migrate``,
``kv.promote``) parented under the submitting thread's trace, a cost
meter per request folded into the tenant ledger at finish (a migrated
request folds once, on the decode side), and the preemption's
``observability.control.record_decision`` call, made as the reference
makes it: the call does not bind, so, as in the reference, no decision
is recorded. Telemetry never breaks a request: every hook is wrapped
where the reference wraps it.

Below the host tier, evicted prefix blocks demote to the object store
(``_tier_store_put``/``_tier_store_get``) when the engine's process has
a cluster attached, as a Serve replica does; without one the put raises
and the tier counts a drop.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device

_LANES = ("interactive", "batch")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shapes of the engine's device state (fixed for its lifetime) and
    its scheduling knobs; the reference's fields and checks."""

    num_slots: int = 8              # B: concurrent sequences in flight
    max_seq_len: int = 512          # S: KV rows per slot
    # Padded prompt lengths; a prompt prefills at the smallest bucket that
    # holds it.
    prefill_buckets: Tuple[int, ...] = (32, 64, 128)
    eos_id: Optional[int] = None    # config-level end-of-sequence token
    # Decode steps per tick. >1 amortizes host round trips at the cost of
    # up to K-1 discarded tokens per finished slot (truncated host-side
    # at the same stop condition, so parity is unaffected).
    decode_block: int = 1
    # "dense": one [S] stripe per slot. "paged": a pool of
    # [kv_block_size]-row blocks shared through per-slot block tables
    # (kv_cache.py). Both are token-exact for greedy decoding.
    kv_layout: str = "dense"
    # None -> GlobalConfig.serve_kv_block_size (RAY_TPU_-overridable).
    kv_block_size: Optional[int] = None
    # Pool size; None -> num_slots * (max_seq_len / kv_block_size), the
    # dense equivalent. Undersize it to oversubscribe device memory:
    # admission queues on exhaustion, never crashes.
    num_kv_blocks: Optional[int] = None
    prefix_cache: bool = True       # paged only: prompt-prefix reuse
    # Speculative decoding (paged only; armed by draft_params): spec_k - 1
    # draft proposals per round. None -> GlobalConfig.serve_spec_k.
    spec_k: Optional[int] = None
    # Batch-lane preemption: interactive pressure must hold
    # preempt_hold_s before a batch decode is checkpointed, and grants are
    # spaced by preempt_cooldown_s. None -> GlobalConfig.
    preempt_hold_s: Optional[float] = None
    preempt_cooldown_s: Optional[float] = None
    # Tiered KV spill: prefix-cache evictions copy their rows into a
    # host-RAM tier and re-admissions promote them back when the
    # PromoteCostModel favours the copy over recompute. None -> on for
    # paged + prefix_cache engines; forced off otherwise.
    kv_spill: Optional[bool] = None
    kv_host_tier_bytes: Optional[int] = None    # None -> GlobalConfig
    # PromoteCostModel knobs, milliseconds; None -> GlobalConfig.
    kv_adopt_cost_fixed_ms: Optional[float] = None
    kv_adopt_cost_per_block_ms: Optional[float] = None
    kv_prefill_cost_per_token_ms: Optional[float] = None

    def __post_init__(self):
        from ray_tpu_torch._private.config import GlobalConfig

        if self.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if not self.prefill_buckets:
            raise ValueError("need at least one prefill bucket")
        if self.spec_k is None:
            object.__setattr__(self, "spec_k",
                               int(GlobalConfig.serve_spec_k))
        if self.spec_k < 2:
            raise ValueError("spec_k must be >= 2 (one draft proposal "
                             "plus the bonus target token)")
        for name in ("preempt_hold_s", "preempt_cooldown_s"):
            if getattr(self, name) is None:
                object.__setattr__(
                    self, name, float(GlobalConfig.get("serve_" + name)))
        b = tuple(sorted(set(int(x) for x in self.prefill_buckets)))
        object.__setattr__(self, "prefill_buckets", b)
        if b[-1] > self.max_seq_len:
            raise ValueError(
                f"largest prefill bucket {b[-1]} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{self.kv_layout!r}")
        if self.kv_spill is None:
            object.__setattr__(
                self, "kv_spill",
                self.kv_layout == "paged" and self.prefix_cache)
        elif self.kv_spill and (self.kv_layout != "paged"
                                or not self.prefix_cache):
            raise ValueError(
                "kv_spill requires kv_layout='paged' with "
                "prefix_cache=True (the spill hook rides prefix-cache "
                "eviction)")
        if self.kv_host_tier_bytes is None:
            object.__setattr__(
                self, "kv_host_tier_bytes",
                int(GlobalConfig.serve_kv_host_tier_bytes))
        for name in ("kv_adopt_cost_fixed_ms", "kv_adopt_cost_per_block_ms",
                     "kv_prefill_cost_per_token_ms"):
            if getattr(self, name) is None:
                object.__setattr__(
                    self, name, float(GlobalConfig.get("serve_" + name)))
        if self.kv_block_size is None:
            object.__setattr__(self, "kv_block_size",
                               int(GlobalConfig.serve_kv_block_size))
        if self.kv_layout == "paged":
            bs = self.kv_block_size
            if bs < 1:
                raise ValueError("kv_block_size must be >= 1")
            if self.max_seq_len % bs:
                raise ValueError(
                    f"max_seq_len {self.max_seq_len} must be a multiple "
                    f"of kv_block_size {bs} (block tables tile the "
                    f"sequence exactly)")
            bad = [x for x in b if x % bs]
            if bad:
                raise ValueError(
                    f"prefill buckets {bad} must be multiples of "
                    f"kv_block_size {bs} (suffix KV scatters whole "
                    f"blocks)")
            if self.num_kv_blocks is not None and self.num_kv_blocks < 1:
                raise ValueError("num_kv_blocks must be >= 1")

    @property
    def max_blocks_per_slot(self) -> int:
        return self.max_seq_len // self.kv_block_size

    @property
    def pool_blocks(self) -> int:
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        return self.num_slots * self.max_blocks_per_slot


@dataclasses.dataclass
class Request:
    """One generation request (token ids; tokenization is the caller's)."""

    prompt: Sequence[int]
    max_tokens: int = 64
    temperature: float = 0.0
    stop: Tuple[int, ...] = ()      # tokens that halt WITHOUT being emitted
    # Streaming hook: on_token(request_id, token_id), called from the
    # scheduler thread as each token lands.
    on_token: Optional[Callable[[int, int], None]] = None
    # Admission lane: "interactive" drains before "batch" and, under
    # pressure, may preempt "batch" decodes (paged layout).
    slo: str = "interactive"
    # Stop after prefill + the first sampled token and export the KV
    # state (handle.kv_state) instead of decoding: the disaggregated
    # prefill tier's mode (serve/llm/disagg). Paged layout only.
    prefill_only: bool = False
    # Paged + prefix-cache engines: admit prompts longer than the largest
    # bucket by prefilling bucket-sized chunks through the prefix cache,
    # one chunk per scheduler step.
    chunked_prefill: bool = False
    # Cost-accounting identity: whose ledger row this request bills to
    # (observability/accounting.py).
    tenant: str = "default"


class RequestHandle:
    """Host-side view of a submitted request; completion is an Event."""

    def __init__(self, request_id: int, request: Request):
        self.request_id = request_id
        self.request = request
        self.tokens: List[int] = []
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # Wall-clock mirror of submitted_at: spans need epoch timestamps,
        # latency math stays monotonic.
        self.submitted_wall = time.time()
        # "eos" | "stop" | "length" | "prefill" | "cancelled"
        self.finish_reason: Optional[str] = None
        # Exported KV checkpoint (kv_cache.KVState): set by prefill_only
        # completion and by preemption; consumed by submit_adopted /
        # readmission.
        self.kv_state: Optional[Any] = None
        # Prompt positions this engine prefilled (the suffix after prefix
        # hits and tier promotes, summed over chunks).
        self.prefilled_tokens = 0
        # Request-scoped tracing: the TraceContext active on the
        # submitting thread, and a span id allocated up front for this
        # request's llm.request span, under which the scheduler thread
        # parents its phase and KV spans.
        self.trace: Optional[Any] = None
        self.trace_span_id: Optional[str] = None
        # Cost meter (observability.accounting.RequestMeter): attached at
        # submit when accounting is on, integrated by the scheduler
        # thread, finalized and folded at finish. None when off.
        self.meter: Optional[Any] = None
        self._done = threading.Event()
        self._engine: Optional["LLMEngine"] = None
        self._chunk_ends: List[int] = []   # chunked-prefill boundaries
        self._chunk_idx = 0
        self._chunk_inserts = 0
        self._adopted_submit = False   # arrived through submit_adopted

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Cancel: a queued request finishes at once as "cancelled"; a
        live one is torn down by the scheduler thread at its next step.
        False if the request already finished."""
        if self._done.is_set() or self._engine is None:
            return False
        return self._engine.cancel(self)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished in {timeout}s")
        return self.tokens

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-output-token latency after the first token."""
        if self.finished_at is None or self.first_token_at is None:
            return None
        n = len(self.tokens)
        if n <= 1:
            return 0.0
        return (self.finished_at - self.first_token_at) / (n - 1)


class _Slot:
    __slots__ = ("handle", "uses")

    def __init__(self):
        self.handle: Optional[RequestHandle] = None
        self.uses = 0


def _sample(logits: torch.Tensor, temp: torch.Tensor,
            gen: torch.Generator) -> torch.Tensor:
    """Per-row sampling: greedy where temp == 0, else temperature sampling
    by the Gumbel-max trick (the method of ``jax.random.categorical``),
    with noise from ``gen``. Both branches run (fixed work per call);
    ``where`` selects. The bits differ from the reference's."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / temp.clamp_min(1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temp > 0, sampled, greedy)


class LLMEngine:
    """Slot-based continuous-batching engine over a Llama param tree.

    Thread model: ``submit()`` and ``cancel()`` are thread-safe;
    ``step()``/``run()`` must be driven by one scheduler thread
    (``deployment.LLMServer`` runs one). ``params`` (and
    ``draft_params``) must already live on ``device`` (default: the
    card)."""

    def __init__(self, params: Any, model_config: Any,
                 engine_config: Optional[EngineConfig] = None,
                 rng_seed: int = 0, draft_params: Any = None,
                 draft_config: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        from ray_tpu_torch.models.llama import (init_kv_cache,
                                                init_paged_kv_cache)
        from ray_tpu_torch.observability.accounting import (
            accounting_enabled)
        from ray_tpu_torch.observability.control import Hysteresis
        from ray_tpu_torch.observability.serve import serve_metrics

        self.device = resolve_device(device)
        for name, tree in (("params", params), ("draft_params",
                                                draft_params)):
            if tree is not None and \
                    tree["embed"].device.type != self.device.type:
                raise ValueError(f"{name} live on {tree['embed'].device}, "
                                 f"engine device is {self.device}")
        self.params = params
        self.model_config = model_config
        self.config = engine_config or EngineConfig()
        c = self.config
        B = c.num_slots

        # Device state, fixed shapes for the engine's whole lifetime.
        self._paged = c.kv_layout == "paged"
        self._allocator = self._prefix = self._tiers = None
        if self._paged:
            from ray_tpu_torch.serve.llm.kv_cache import (
                BlockAllocator, KVTierManager, PrefixCache,
                PromoteCostModel)

            self._cache = init_paged_kv_cache(
                model_config, c.pool_blocks, c.kv_block_size,
                device=self.device)
            # Device bytes per block (k + v rows across all layers).
            k = self._cache["k"]
            block_bytes = 2 * k[:, 0].numel() * k.element_size()
            self._allocator = BlockAllocator(c.pool_blocks,
                                             c.kv_block_size,
                                             block_bytes=block_bytes)
            self._prefix = (PrefixCache(self._allocator)
                            if c.prefix_cache else None)
            # Per-slot block tables: the host copy is the truth, sent to
            # the device with each tick.
            self._tables = np.zeros((B, c.max_blocks_per_slot), np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
            # Counter values already pushed to the serve metrics.
            self._prefix_seen = {"hits": 0, "misses": 0, "hit_tokens": 0,
                                 "evictions": 0}
            self._cost_model = PromoteCostModel(
                adopt_fixed_s=c.kv_adopt_cost_fixed_ms * 1e-3,
                adopt_per_block_s=c.kv_adopt_cost_per_block_ms * 1e-3,
                prefill_per_token_s=c.kv_prefill_cost_per_token_ms
                * 1e-3)
            if c.kv_spill and self._prefix is not None:
                # Host overflow demotes to the object store; without a
                # cluster the put raises and the tier counts a drop.
                self._tiers = KVTierManager(
                    c.kv_host_tier_bytes, c.kv_block_size,
                    put_fn=_tier_store_put, get_fn=_tier_store_get)
                self._prefix.spill_fn = self._spill_evicted
        else:
            self._cache = init_kv_cache(model_config, B, c.max_seq_len,
                                        device=self.device)
        self._tok = torch.zeros((B,), dtype=torch.long, device=self.device)
        self._pos = torch.zeros((B,), dtype=torch.long, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        # Host-side mirrors fed into each tick.
        self._active = np.zeros((B,), bool)
        self._temp = np.zeros((B,), np.float32)

        # Host-side scheduler state; queue access is under _lock.
        self._slots = [_Slot() for _ in range(B)]
        self._free: deque = deque(range(B))
        self._queues: Dict[str, deque] = {lane: deque() for lane in _LANES}
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._ids = itertools.count()
        self._completed = 0
        self._slot_reuses = 0
        self._prefills = 0
        self._cancelled: set = set()    # request ids, guarded by _lock
        self._admit_blocked = False     # interactive admission starved
        self._block_waits = 0           # admissions requeued for blocks
        self._chunked_prompts = 0       # prompts admitted in >= 2 chunks
        self._chunk_inserts = 0         # their inserts
        self._preempted = 0
        self._migrated_blocks = 0       # checkpoints adopted into the pool
        self._migrated_bytes = 0
        self._promoted_blocks = 0       # tier blocks adopted back
        self._promote_skips = 0         # cost model chose recompute
        self._tier_seen = {t: {"hits": 0, "misses": 0, "spills": 0,
                               "promotes": 0}
                           for t in ("host", "store")}
        # Control calls from other threads, run by step() on the
        # scheduler thread (the only one that touches device state).
        self._ctrl_q: deque = deque()
        self._preempt_gate = Hysteresis(
            up_delay_s=c.preempt_hold_s, down_delay_s=0.0,
            cooldown_s=c.preempt_cooldown_s)

        # Speculative decoding: the draft keeps a dense per-slot cache (it
        # is small; paging it would buy nothing).
        self._draft = draft_params
        self.draft_config = draft_config
        self._spec_ok = np.zeros((B,), bool)
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._draft_prefills = 0
        if draft_params is not None:
            if not self._paged:
                raise ValueError(
                    "speculative decoding requires kv_layout='paged' "
                    "(the verify step goes through block tables)")
            if draft_config is None:
                raise ValueError("draft_params given without draft_config")
            self._draft_cache = init_kv_cache(draft_config, B,
                                              c.max_seq_len,
                                              device=self.device)

        # Program tracking through the program plane: each tracked
        # callable counts its argument signatures as traces (one per
        # program the reference compiles), so trace_count is bounded by
        # the per-family budgets as there: ONE tick and one insert per
        # prefill bucket, plus at most one export, one adopt, one
        # speculative round and one draft insert per bucket. Export and
        # adopt take fixed-shape arguments for that (a padded table row
        # or id row and the valid count), and copy only the valid blocks.
        from ray_tpu_torch.observability.device import (
            ensure_sampler_registered)
        from ray_tpu_torch.observability.jit import tracked_jit

        n_buckets = len(c.prefill_buckets)
        # Host blocks [L, n, bs, n_kv, hd] for the next adopt: they reach
        # it through the engine, not as arguments, so the adopt program's
        # signature stays fixed.
        self._staged_blocks: Optional[Tuple[torch.Tensor, torch.Tensor]] = \
            None
        if self._paged:
            self._jit_tick = tracked_jit(
                self._tick_fn_paged, name="llm_engine_tick", trace_budget=1)
            self._jit_insert = tracked_jit(
                self._insert_fn_paged, name="llm_engine_insert",
                trace_budget=n_buckets)
            self._jit_export = tracked_jit(
                self._export_fn, name="llm_engine_export", trace_budget=1)
            self._jit_adopt = tracked_jit(
                self._adopt_fn, name="llm_engine_adopt", trace_budget=1)
            if self._draft is not None:
                self._jit_spec = tracked_jit(
                    self._spec_fn, name="llm_engine_spec", trace_budget=1)
                self._jit_draft_insert = tracked_jit(
                    self._draft_insert_fn, name="llm_engine_draft_insert",
                    trace_budget=n_buckets)
        else:
            self._jit_tick = tracked_jit(
                self._tick_fn, name="llm_engine_tick", trace_budget=1)
            self._jit_insert = tracked_jit(
                self._insert_fn, name="llm_engine_insert",
                trace_budget=n_buckets)
        self._metrics = serve_metrics()
        ensure_sampler_registered()
        # Per-request cost accounting. The gate is latched once per
        # engine: meters attach at submit, so flipping the knob mid-flight
        # would half-meter requests.
        self._acct = accounting_enabled()
        mc = model_config
        self._model_label = (f"llama_d{getattr(mc, 'dim', 0)}"
                             f"_l{getattr(mc, 'n_layers', 0)}")

    # ------------------------------------------------------ device programs

    def _decode_block(self, step_fn) -> np.ndarray:
        """``decode_block`` decode steps for all B slots, each
        ``step_fn(tok, pos, active) -> logits``. Inactive slots are
        computed but masked: no KV write, token/pos parked. Positions
        clamp at S-1 so a slot finishing mid-block never attends past rows
        it wrote itself; the host discards post-stop tokens. Returns the
        tokens [K, B] on the host."""
        S = self.config.max_seq_len
        active = torch.from_numpy(self._active.copy()).to(self.device)
        temp = torch.from_numpy(self._temp.copy()).to(self.device)
        tok, pos = self._tok, self._pos
        toks = []
        for _ in range(self.config.decode_block):
            nxt = _sample(step_fn(tok, pos, active), temp, self._gen)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, torch.clamp(pos + 1, max=S - 1), pos)
            toks.append(tok)
        self._tok, self._pos = tok, pos
        return torch.stack(toks).cpu().numpy()

    def _tick_fn(self) -> np.ndarray:
        from ray_tpu_torch.models.llama import decode_step

        return self._decode_block(lambda tok, pos, active: decode_step(
            self.params, self._cache, tok, pos, self.model_config,
            active=active)[0])

    def _tick_fn_paged(self) -> np.ndarray:
        """Paged twin of ``_tick_fn``: the KV write and read go through
        the block tables."""
        from ray_tpu_torch.models.llama import decode_step_paged

        tables = self._tables_dev()
        return self._decode_block(lambda tok, pos, active: decode_step_paged(
            self.params, self._cache, tables, tok, pos, self.model_config,
            active=active)[0])

    def _tables_dev(self) -> torch.Tensor:
        return torch.from_numpy(self._tables.copy()).to(self.device)

    def _first_token(self, x_last: torch.Tensor, slot: int,
                     temperature: float, pos: int) -> None:
        """Sample a slot's first token from its last real prompt row's
        hidden state [D] and park the slot at ``pos``."""
        from ray_tpu_torch.models.llama import lm_head_weight

        logits = (x_last[None].float()
                  @ lm_head_weight(self.params, self.model_config).float())
        temp = torch.tensor([temperature], dtype=torch.float32,
                            device=self.device)
        self._tok[slot] = _sample(logits, temp, self._gen)[0]
        self._pos[slot] = pos
        self._prefills += 1

    def _insert_fn(self, padded_prompt: np.ndarray, prompt_len: int,
                   slot: int, temperature: float) -> None:
        """Prefill one bucket-padded prompt, write its KV into the shared
        cache at ``slot`` (in place), and sample the first generated token
        from the logits at the last REAL prompt position."""
        from ray_tpu_torch.models.llama import prefill_kv

        tokens = torch.from_numpy(padded_prompt).to(self.device)[None]
        hidden, ks, vs = prefill_kv(self.params, tokens, self.model_config)
        Pb = padded_prompt.shape[0]
        self._cache["k"][:, slot, :Pb] = ks[:, 0]
        self._cache["v"][:, slot, :Pb] = vs[:, 0]
        self._first_token(hidden[0, prompt_len - 1], slot, temperature,
                          prompt_len)

    def _insert_fn_paged(self, table_row: np.ndarray, hist_len: int,
                         padded_suffix: np.ndarray, suffix_len: int,
                         new_block_ids: np.ndarray, slot: int,
                         temperature: float) -> None:
        """Prefill the (possibly prefix-truncated) suffix of one prompt
        over the slot's history and scatter its KV into the slot's fresh
        blocks, whole blocks at a time (padding rows ride along; decode
        overwrites each before attending). A miss is ``hist_len = 0``."""
        from ray_tpu_torch.models.llama import prefill_kv_paged

        pools = self._cache
        L, _, bs, n_kv, hd = pools["k"].shape
        S_pad = self.config.max_blocks_per_slot * bs
        Pb = padded_suffix.shape[0]
        row = torch.from_numpy(table_row).to(self.device).long()
        hist_k = pools["k"][:, row].reshape(L, S_pad, n_kv, hd)
        hist_v = pools["v"][:, row].reshape(L, S_pad, n_kv, hd)
        tokens = torch.from_numpy(padded_suffix).to(self.device)[None]
        hidden, ks, vs = prefill_kv_paged(self.params, tokens, hist_len,
                                          hist_k, hist_v, self.model_config)
        ids = torch.from_numpy(new_block_ids).to(self.device).long()
        dtype = pools["k"].dtype
        pools["k"][:, ids] = ks[:, 0].to(dtype).reshape(L, Pb // bs, bs,
                                                        n_kv, hd)
        pools["v"][:, ids] = vs[:, 0].to(dtype).reshape(L, Pb // bs, bs,
                                                        n_kv, hd)
        self._first_token(hidden[0, suffix_len - 1], slot, temperature,
                          hist_len + suffix_len)

    def _export_fn(self, table_row: np.ndarray, n_valid: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy the first ``n_valid`` blocks of a table row [max_blocks]
        to the host: CPU tensors [L, n_valid, bs, n_kv, hd], one gather
        and one copy per tensor. The row's fixed shape keeps this one
        program; only the valid blocks are copied (the reference gathers
        the whole row and the host slices it)."""
        ids = torch.from_numpy(np.ascontiguousarray(
            table_row[:n_valid])).to(self.device).long()
        return (self._cache["k"][:, ids].cpu(),
                self._cache["v"][:, ids].cpu())

    def _adopt_fn(self, scatter_ids: np.ndarray, n_valid: int) -> None:
        """Copy the staged host blocks into the pool at the first
        ``n_valid`` of ``scatter_ids`` (padded to max_blocks with the pool
        size, as the reference pads them; only the valid ids are
        written)."""
        kb, vb = self._staged_blocks
        self._staged_blocks = None
        ids = torch.from_numpy(np.ascontiguousarray(
            scatter_ids[:n_valid])).to(self.device).long()
        self._cache["k"][:, ids] = kb.to(self.device)
        self._cache["v"][:, ids] = vb.to(self.device)

    def _padded_ids(self, ids: Sequence[int], fill: int) -> np.ndarray:
        """``ids`` in a [max_blocks] int32 row (a block table's type),
        padded with ``fill``."""
        row = np.full((self.config.max_blocks_per_slot,), fill, np.int32)
        row[:len(ids)] = np.asarray(ids, np.int32)
        return row

    def _draft_insert_fn(self, padded_prompt: np.ndarray, slot: int) -> None:
        """Prefill the draft model's dense cache for one admitted slot
        (the whole padded prompt: the draft has no prefix cache)."""
        from ray_tpu_torch.models.llama import prefill_kv

        tokens = torch.from_numpy(padded_prompt).to(self.device)[None]
        _, ks, vs = prefill_kv(self._draft, tokens, self.draft_config)
        Pb = padded_prompt.shape[0]
        self._draft_cache["k"][:, slot, :Pb] = ks[:, 0]
        self._draft_cache["v"][:, slot, :Pb] = vs[:, 0]
        self._draft_prefills += 1

    def _spec_fn(self) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative round (greedy lanes only): the draft proposes
        spec_k - 1 tokens from its dense cache, one paged verify call
        scores all spec_k inputs on the target, and the longest draft
        prefix agreeing with the target's argmax is accepted. Every
        emitted token is the target's argmax given correct inputs, so a
        round gives the tokens of 1..spec_k plain ticks; a zero-accept
        round still emits the one token a plain tick would. Rejected
        inputs leave stale rows past the new position in both caches,
        overwritten before they are attended. Returns (target tokens
        [K, B], n_emit [B]) on the host."""
        from ray_tpu_torch.models.llama import decode_step, verify_kv_paged

        c = self.config
        K, S = c.spec_k, c.max_seq_len
        active = torch.from_numpy(self._active.copy()).to(self.device)
        tok, pos = self._tok, self._pos
        dtok, dpos = tok, pos
        drafts = []
        for _ in range(K - 1):
            dlogits, _ = decode_step(self._draft, self._draft_cache, dtok,
                                     dpos, self.draft_config, active=active)
            dtok = torch.where(active, torch.argmax(dlogits, dim=-1), dtok)
            dpos = torch.where(active, torch.clamp(dpos + 1, max=S - 1),
                               dpos)
            drafts.append(dtok)
        drafts = torch.stack(drafts, dim=1)                  # [B, K-1]
        # The accepted stream so far ends at tok (sampled, unconsumed).
        inputs = torch.cat([tok[:, None], drafts], dim=1)    # [B, K]
        logits, _ = verify_kv_paged(self.params, self._cache,
                                    self._tables_dev(), inputs, pos,
                                    self.model_config, active=active)
        t = torch.argmax(logits, dim=-1)                     # [B, K]
        # Draft j+1 survives iff the target's argmax after input j equals
        # it; acceptance is the leading run of agreements.
        agree = (t[:, :-1] == drafts).long()
        acc = torch.cumprod(agree, dim=1).sum(dim=1)          # 0..K-1
        n_emit = torch.where(active, acc + 1, torch.zeros_like(acc))
        B = tok.shape[0]
        new_tok = t[torch.arange(B, device=self.device),
                    torch.clamp(n_emit, min=1) - 1]
        self._tok = torch.where(active, new_tok, tok)
        self._pos = torch.where(active,
                                torch.clamp(pos + n_emit, max=S - 1), pos)
        return t.cpu().numpy().T, n_emit.cpu().numpy()

    # ----------------------------------------------------------- submission

    def submit(self, request: Request) -> RequestHandle:
        c = self.config
        P = len(request.prompt)
        top = c.prefill_buckets[-1]
        if P == 0:
            raise ValueError("empty prompt")
        if request.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if request.slo not in _LANES:
            raise ValueError(
                f"slo must be 'interactive' or 'batch', got "
                f"{request.slo!r}")
        if request.prefill_only and not self._paged:
            raise ValueError(
                "prefill_only requires kv_layout='paged' (the exported "
                "checkpoint is a set of KV blocks)")
        handle = RequestHandle(next(self._ids), request)
        if request.chunked_prefill and P > top:
            if not (self._paged and self._prefix is not None):
                raise ValueError(
                    "chunked_prefill needs kv_layout='paged' with "
                    "prefix_cache=True (chunks hand off through the "
                    "prefix cache)")
            if P >= c.max_seq_len or -(-P // top) * top > c.max_seq_len:
                raise ValueError(
                    f"prompt length {P} cannot be chunk-prefilled: "
                    f"ceil({P}/{top}) bucket-sized chunks exceed "
                    f"max_seq_len {c.max_seq_len}")
            handle._chunk_ends = list(range(top, P, top)) + [P]
        elif P > top:
            raise ValueError(
                f"prompt length {P} exceeds largest prefill bucket {top} "
                f"(set chunked_prefill=True on a paged + prefix-cache "
                f"engine)")
        if self._paged:
            # A request the pool can never hold fails here: queueing it
            # would stall admission forever.
            worst = max(self._blocks_needed(P, request.max_tokens),
                        self._bucket_for(min(P, top)) // c.kv_block_size)
            if worst > c.pool_blocks:
                raise ValueError(
                    f"request needs up to {worst} KV blocks but the pool "
                    f"only has {c.pool_blocks}; raise num_kv_blocks or "
                    f"lower max_tokens")
        handle._engine = self
        self._capture_trace(handle)
        self._attach_meter(handle)
        with self._lock:
            self._queues[request.slo].append(handle)
        self._work.set()
        return handle

    def _attach_meter(self, handle: RequestHandle) -> None:
        """Attach a cost meter (after _capture_trace: the meter is stamped
        with the captured trace id)."""
        if not self._acct:
            return
        try:
            from ray_tpu_torch.observability.accounting import RequestMeter

            req = handle.request
            handle.meter = RequestMeter(
                tenant=req.tenant, model=self._model_label, lane=req.slo,
                trace_id=(handle.trace.trace_id if handle.trace
                          else None),
                request_id=handle.request_id)
        except Exception:
            handle.meter = None   # accounting must never break submit

    def submit_adopted(self, request: Request, state: Any, *,
                       front: bool = False,
                       meter_snapshot: Optional[Dict[str, Any]] = None
                       ) -> RequestHandle:
        """Submit a request whose prefill ran elsewhere: ``state`` is the
        kv_cache.KVState exported by the prefill tier (or by preemption).
        Admission adopts the blocks into this engine's pool through
        ``_admit_adopted`` (the path preemption resumes by) and decoding
        continues where the checkpoint stopped, token for token what one
        engine would have produced. ``front=True`` queues at the lane's
        head (resume order). ``meter_snapshot`` is the prefill side's cost
        meter, absorbed so the migrated request bills one ledger row."""
        from ray_tpu_torch.serve.llm.kv_cache import KVState

        c = self.config
        if not self._paged:
            raise ValueError("submit_adopted requires kv_layout='paged'")
        if not isinstance(state, KVState):
            raise TypeError(f"expected KVState, got {type(state)!r}")
        state.validate()
        if state.block_size != c.kv_block_size:
            raise ValueError(
                f"KVState block_size {state.block_size} != engine "
                f"kv_block_size {c.kv_block_size}")
        if list(request.prompt) != list(state.prompt):
            raise ValueError(
                "request.prompt does not match the exported KVState "
                "prompt (the checkpoint is prompt-specific)")
        if request.max_tokens <= len(state.tokens):
            raise ValueError(
                f"max_tokens {request.max_tokens} already reached by the "
                f"checkpoint ({len(state.tokens)} tokens)")
        if request.slo not in _LANES:
            raise ValueError(
                f"slo must be 'interactive' or 'batch', got "
                f"{request.slo!r}")
        need = max(self._blocks_needed(len(request.prompt),
                                       request.max_tokens), state.n_blocks)
        if need > c.pool_blocks:
            raise ValueError(
                f"adopted request needs up to {need} KV blocks but the "
                f"pool only has {c.pool_blocks}")
        handle = RequestHandle(next(self._ids), request)
        handle._engine = self
        handle._adopted_submit = True
        self._capture_trace(handle)
        self._attach_meter(handle)
        if handle.meter is not None and meter_snapshot:
            handle.meter.absorb(meter_snapshot)
        handle.tokens = list(state.tokens)
        handle.kv_state = state
        with self._lock:
            q = self._queues[request.slo]
            if front:
                q.appendleft(handle)
            else:
                q.append(handle)
        self._work.set()
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a submitted request. Queued handles finish here; live
        ones are marked and torn down by the scheduler thread (slot,
        blocks and prefix refs released there)."""
        with self._lock:
            if handle._done.is_set():
                return False
            for q in self._queues.values():
                if handle in q:
                    q.remove(handle)
                    break
            else:
                self._cancelled.add(handle.request_id)
                self._work.set()
                return True
        self._finish_cancelled(handle)
        return True

    def _finish_cancelled(self, handle: RequestHandle) -> None:
        handle.finish_reason = "cancelled"
        handle.finished_at = time.monotonic()
        self._completed += 1
        self._record_finished(handle)
        handle._done.set()

    def has_work(self) -> bool:
        return (any(self._queues.values()) or bool(self._active.any())
                or bool(self._cancelled) or bool(self._ctrl_q))

    # ------------------------------------------------------------ scheduling

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(n)  # pre-checked in submit()

    def _blocks_needed(self, prompt_len: int, max_tokens: int) -> int:
        """Blocks covering every position this request can ever write:
        prompt + generated tokens + up to decode_block - 1 (or spec_k - 1
        with a draft: a verify step writes spec_k rows) writes past the
        stop condition, capped at the sequence limit."""
        c = self.config
        over = max(c.decode_block,
                   c.spec_k if self._draft is not None else 1)
        top = min(prompt_len + max_tokens + over - 1, c.max_seq_len)
        return -(-top // c.kv_block_size)

    def _pop_next(self) -> Optional[RequestHandle]:
        """Next admissible handle, interactive lane first."""
        with self._lock:
            for lane in _LANES:
                if self._queues[lane]:
                    return self._queues[lane].popleft()
        return None

    def _requeue(self, handle: RequestHandle, *, front: bool = True) -> None:
        with self._lock:
            q = self._queues[handle.request.slo]
            if front:
                q.appendleft(handle)
            else:
                q.append(handle)

    def _admit(self) -> List[Tuple[int, bool]]:
        """Move queued requests into free slots (one prefill each);
        returns the (slot, fresh) pairs filled this step. ``fresh`` is
        False for a resumed checkpoint, whose pending token was emitted
        before it was preempted. Paged layout: admission also needs
        blocks; on exhaustion the request goes back to its lane's head and
        admission stops until finishing sequences free blocks.
        Intermediate chunks of a chunked prefill are throwaway admissions
        (their KV lands in the prefix cache and the slot stays free), one
        per step, so interactive admissions interleave with a long
        prefill."""
        inserted: List[Tuple[int, bool]] = []
        chunk_budget = 1
        while self._free:
            handle = self._pop_next()
            if handle is None:
                break
            if handle._done.is_set():
                continue   # cancelled while queued by a racing cancel()
            req = handle.request
            if handle._chunk_ends and \
                    handle._chunk_idx < len(handle._chunk_ends) - 1:
                if chunk_budget == 0:
                    self._requeue(handle)
                    break
                end = handle._chunk_ends[handle._chunk_idx]
                t_chunk = time.monotonic()
                if not self._admit_paged(handle, self._free[0], upto=end,
                                         throwaway=True):
                    self._requeue(handle)
                    self._block_waits += 1
                    if req.slo == "interactive":
                        self._admit_blocked = True
                    break
                if handle.meter is not None:
                    handle.meter.note_chip("prefill",
                                           time.monotonic() - t_chunk)
                chunk_budget -= 1
                handle._chunk_idx += 1
                self._requeue(handle)
                continue
            slot = self._free.popleft()
            fresh = handle.kv_state is None
            t_admit = time.monotonic()
            if not fresh:
                ok = self._admit_adopted(handle, slot)
            elif self._paged:
                ok = self._admit_paged(handle, slot)
            else:
                P = len(req.prompt)
                padded = np.zeros((self._bucket_for(P),), np.int64)
                padded[:P] = np.asarray(req.prompt, np.int64)
                self._jit_insert(padded, P, slot, float(req.temperature))
                handle.prefilled_tokens += P
                ok = True
            if not ok:
                self._free.appendleft(slot)
                self._block_waits += 1
                if req.slo == "interactive":
                    self._admit_blocked = True
                self._requeue(handle)
                break
            if handle._chunk_inserts >= 2 and fresh:
                self._chunked_prompts += 1
                self._chunk_inserts += handle._chunk_inserts
            if self._draft is not None and fresh:
                self._draft_admit(list(req.prompt), slot)
            if handle.meter is not None:
                # The admission (insert or adopt, and the draft's seed) is
                # this request's prefill time, resumes included.
                handle.meter.note_chip("prefill", time.monotonic() - t_admit)
            if handle.admitted_at is None:
                handle.admitted_at = time.monotonic()
                self._metrics.queue_wait.observe(
                    handle.admitted_at - handle.submitted_at)
                if handle.meter is not None:
                    handle.meter.note_queue_wait(
                        handle.admitted_at - handle.submitted_at)
            st = self._slots[slot]
            if st.uses:
                self._slot_reuses += 1
                self._metrics.slot_reuses.inc()
            st.uses += 1
            st.handle = handle
            self._active[slot] = True
            self._temp[slot] = req.temperature
            inserted.append((slot, fresh))
        return inserted

    def _admit_paged(self, handle: RequestHandle, slot: int,
                     upto: Optional[int] = None,
                     throwaway: bool = False) -> bool:
        """Block accounting + paged insert for one request. Returns False
        (nothing allocated, nothing inserted) when the pool cannot cover
        it even after evicting cold prefix entries.

        ``upto`` prefills only prompt[:upto] (a chunk); ``throwaway``
        keeps the slot free: the KV outlives the admission only through
        the prefix-cache refs taken at insert, so the next chunk (or the
        final admission) prefix-hits it. A throwaway insert's sampled
        token is never read: the slot stays inactive."""
        req = handle.request
        c = self.config
        bs = c.kv_block_size
        prompt = req.prompt if upto is None else req.prompt[:upto]
        P = len(prompt)
        if throwaway:
            # Only the chunk itself; headroom is the final admission's.
            need_total = -(-P // bs)
        else:
            need_total = self._blocks_needed(P, req.max_tokens)

        # Longest cached prefix, capped so the LAST prompt token is always
        # prefilled (its logits seed the first sampled token).
        hit_blocks: List[int] = []
        if self._prefix is not None:
            hit_blocks = self._prefix.match(prompt,
                                            max_blocks=(P - 1) // bs)
        if P - len(hit_blocks) * bs > c.prefill_buckets[-1]:
            # A chunked continuation whose earlier chunks were evicted
            # before this admission: rewind the chunk plan to what the
            # cache still covers and re-chunk.
            self._allocator.free(hit_blocks)
            handle._chunk_idx = (len(hit_blocks) * bs) \
                // c.prefill_buckets[-1]
            return False
        # Trim the hit so history + the padded suffix bucket still fit in
        # the slot's table (prefill_kv_paged raises past it, where the
        # reference's dynamic_update_slice would clamp).
        while hit_blocks:
            hl = len(hit_blocks) * bs
            if hl + self._bucket_for(P - hl) <= c.max_seq_len:
                break
            self._allocator.free([hit_blocks.pop()])
        n_hit = len(hit_blocks)
        # Tier continuation: extend the pool hit with spilled chain links,
        # adopted back only when the cost model says the copy beats
        # recomputing those positions.
        promote: List[Any] = []
        if self._tiers is not None and self._prefix is not None:
            cap = (P - 1) // bs - n_hit
            if cap > 0:
                promote = self._tiers.lookup(prompt, bs, start_depth=n_hit,
                                             max_blocks=cap)
            while promote:          # the same table-fit trim
                hl = (n_hit + len(promote)) * bs
                if hl + self._bucket_for(P - hl) <= c.max_seq_len:
                    break
                promote.pop()
            if promote and not self._cost_model.should_promote(
                    len(promote), bs):
                self._promote_skips += len(promote)
                promote = []
        while True:
            n_pro = len(promote)
            hist_len = (n_hit + n_pro) * bs
            suffix_len = P - hist_len
            bucket = self._bucket_for(suffix_len)
            # Fresh blocks: the rest of the sequence, but at least the
            # promoted links plus the whole suffix bucket (every block a
            # scatter writes must be this slot's).
            n_new = max(need_total - n_hit, n_pro + bucket // bs)
            new_blocks = self._allocator.alloc(n_new)
            if new_blocks is None and self._prefix is not None:
                self._prefix.evict(n_new - self._allocator.free_blocks)
                new_blocks = self._allocator.alloc(n_new)
            if new_blocks is not None or not promote:
                break
            # All-or-nothing promote: drop it (tier entries untouched) and
            # retry as a plain recompute.
            promote = []
        if new_blocks is None:
            if hit_blocks:
                self._allocator.free(hit_blocks)
            return False

        blocks = hit_blocks + new_blocks
        row = np.zeros((c.max_blocks_per_slot,), np.int32)
        row[:len(blocks)] = blocks
        if not throwaway:
            self._tables[slot] = row
            self._slot_blocks[slot] = blocks
            if handle.meter is not None:
                # Block-seconds open here and close in _release_slot with
                # the same count; throwaway chunks skip it (their KV is
                # the prefix cache's once the insert returns).
                handle.meter.blocks_acquired(len(blocks))
        if promote:
            # Land the tier links in new_blocks[:n_pro] BEFORE the insert
            # reads them as history.
            self._promote_tier_hits(promote, new_blocks[:n_pro],
                                    handle=handle)
        padded = np.zeros((bucket,), np.int64)
        padded[:suffix_len] = np.asarray(prompt[hist_len:], np.int64)
        scatter_ids = np.asarray(new_blocks[n_pro:n_pro + bucket // bs],
                                 np.int64)
        self._jit_insert(row, int(hist_len), padded, int(suffix_len),
                         scatter_ids, int(slot), float(req.temperature))
        handle.prefilled_tokens += suffix_len
        if handle._chunk_ends:
            handle._chunk_inserts += 1
        if self._prefix is not None:
            # Register the prompt's FULL blocks so the next request
            # sharing this prefix skips their prefill.
            full = P // bs
            if full:
                self._prefix.insert(prompt, blocks[:full])
        if throwaway:
            # The prefix cache now owns the chunk's full blocks; drop this
            # admission's transient refs.
            self._allocator.free(blocks)
        return True

    def _admit_adopted(self, handle: RequestHandle, slot: int) -> bool:
        """Adopt a KVState checkpoint into the pool and resume the
        sequence in ``slot``. All-or-nothing: every block the sequence can
        ever need is allocated (evicting cold prefix entries if that
        closes the gap) and the copy runs, or nothing changes and the
        request stays queued."""
        t_mig = time.time()
        req = handle.request
        st = handle.kv_state
        c = self.config
        n_valid = st.n_blocks
        need_total = max(self._blocks_needed(len(req.prompt),
                                             req.max_tokens), n_valid)
        blocks = self._allocator.adopt(need_total, self._prefix)
        if blocks is None:
            return False
        row = np.zeros((c.max_blocks_per_slot,), np.int32)
        row[:need_total] = blocks
        self._tables[slot] = row
        self._slot_blocks[slot] = blocks
        if handle.meter is not None:
            handle.meter.blocks_acquired(len(blocks))
        self._staged_blocks = (st.k_blocks, st.v_blocks)
        self._jit_adopt(self._padded_ids(blocks[:n_valid], c.pool_blocks),
                        int(n_valid))
        self._tok[slot] = st.next_tok
        self._pos[slot] = st.pos
        if self._prefix is not None:
            # Shared prompts stay warm across the checkpoint.
            full = min(len(req.prompt) // c.kv_block_size, n_valid)
            if full:
                self._prefix.insert(req.prompt, blocks[:full])
        self._migrated_blocks += n_valid
        self._migrated_bytes += st.payload_bytes
        self._metrics.kv_migrated_blocks.inc(float(n_valid))
        self._metrics.kv_migrated_bytes.inc(float(st.payload_bytes))
        try:
            from ray_tpu_torch.util.tracing import record_span

            record_span("kv.migrate", t_mig, time.time() - t_mig,
                        attrs={"blocks": int(n_valid),
                               "bytes": int(st.payload_bytes)},
                        trace=self._phase_trace(handle))
        except Exception:
            pass  # telemetry must never break admission
        handle.kv_state = None
        if self._draft is not None:
            # The draft cache was not checkpointed: re-prefill it with
            # everything the sequence has consumed so far.
            self._draft_admit(list(req.prompt) + list(handle.tokens[:-1]),
                              slot)
        return True

    def _draft_admit(self, consumed: List[int], slot: int) -> None:
        """Prefill the draft's dense cache with a slot's consumed tokens.
        A sequence longer than the largest bucket cannot seed the draft in
        one insert; it decodes without speculation (spec_ok stays False,
        the plain tick handles it)."""
        n = len(consumed)
        if n > self.config.prefill_buckets[-1]:
            self._spec_ok[slot] = False
            return
        padded = np.zeros((self._bucket_for(n),), np.int64)
        padded[:n] = np.asarray(consumed, np.int64)
        self._jit_draft_insert(padded, int(slot))
        self._spec_ok[slot] = True

    def _release_slot(self, slot: int, donate: bool = False) -> None:
        """Clear a slot's scheduler state and reclaim its blocks.
        ``donate=True`` hands the blocks over after an export
        (``BlockAllocator.donate`` checks they are still live)."""
        st = self._slots[slot]
        handle = st.handle
        st.handle = None
        self._active[slot] = False
        self._temp[slot] = 0.0
        self._spec_ok[slot] = False
        if self._paged and self._slot_blocks[slot]:
            # Blocks shared with the prefix cache stay resident.
            if handle is not None and handle.meter is not None:
                # Close the block-seconds interval with the count it
                # opened with; a resume reopens it at re-admission.
                handle.meter.blocks_released(len(self._slot_blocks[slot]))
            if donate:
                self._allocator.donate(self._slot_blocks[slot])
            else:
                self._allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self._free.append(slot)

    def _emit(self, slot: int, token: int) -> None:
        """Record one generated token for ``slot``; free the slot when the
        request is finished (eos/stop halt, max_tokens bounds)."""
        handle = self._slots[slot].handle
        req = handle.request
        now = time.monotonic()
        reason = None
        if token in req.stop:
            reason = "stop"                      # halt, token NOT emitted
        else:
            handle.tokens.append(token)
            if handle.first_token_at is None:
                handle.first_token_at = now
            if req.on_token is not None:
                try:
                    req.on_token(handle.request_id, token)
                except Exception:
                    pass                          # streaming is best-effort
            if (self.config.eos_id is not None
                    and token == self.config.eos_id):
                reason = "eos"                   # halt, eos IS emitted
            elif len(handle.tokens) >= req.max_tokens:
                reason = "length"
        # Hard cap: the NEXT token would land at pos = prompt +
        # len(tokens); stop while it still fits in the slot's rows.
        if reason is None and (len(req.prompt) + len(handle.tokens)
                               >= self.config.max_seq_len):
            reason = "length"
        if reason is not None:
            handle.finish_reason = reason
            handle.finished_at = now
            self._release_slot(slot)
            self._completed += 1
            self._record_finished(handle)
            handle._done.set()

    def _finish_prefill(self, slot: int, token: int) -> None:
        """Prefill-only completion: record the first sampled token, export
        the slot's KV blocks as the handle's checkpoint, and free the slot
        (its blocks donated). A request that already ends at its first
        token (stop, eos, length) finishes with that reason and exports
        nothing: the decode tier has nothing left to do."""
        handle = self._slots[slot].handle
        req = handle.request
        now = time.monotonic()
        reason = None
        if token in req.stop:
            reason = "stop"
        else:
            handle.tokens.append(token)
            handle.first_token_at = now
            if (self.config.eos_id is not None
                    and token == self.config.eos_id):
                reason = "eos"
            elif req.max_tokens <= 1 or \
                    len(req.prompt) + 1 >= self.config.max_seq_len:
                reason = "length"
        donate = False
        if reason is None:
            handle.kv_state = self._export_state(slot)
            reason = "prefill"
            donate = True
        handle.finish_reason = reason
        handle.finished_at = now
        self._release_slot(slot, donate=donate)
        self._completed += 1
        self._record_finished(handle)
        handle._done.set()

    def _export_state(self, slot: int) -> Any:
        """Snapshot a live slot's sequence as a host-side KVState: copies
        of its valid KV blocks (one copy per tensor) and the resume
        bookkeeping (consumed position, pending sampled token)."""
        from ray_tpu_torch.serve.llm.kv_cache import KVState

        handle = self._slots[slot].handle
        req = handle.request
        bs = self.config.kv_block_size
        pos = int(self._pos[slot])
        n_valid = -(-pos // bs)
        kb, vb = self._jit_export(self._tables[slot].copy(), int(n_valid))
        state = KVState(prompt=list(req.prompt), tokens=list(handle.tokens),
                        next_tok=int(self._tok[slot]), pos=pos,
                        temperature=req.temperature, block_size=bs,
                        k_blocks=kb, v_blocks=vb)
        state.validate()
        return state

    # ------------------------------------------------------- KV tiering

    def _spill_evicted(self, victims: List[Any]) -> int:
        """PrefixCache eviction hook: copy the victims' pool rows (still
        cache-owned here; the free comes after) to the host in one copy
        per tensor and park them in the tier manager, one single-block
        KVPrefix per chain link. Runs on the scheduler thread (eviction
        only happens there)."""
        from ray_tpu_torch.serve.llm.kv_cache import KVPrefix

        if self._tiers is None:
            return 0
        ents = [e for e in victims if e.tokens]
        if not ents:
            return 0
        nb = self.config.max_blocks_per_slot
        prefixes: List[Any] = []
        # Through the one export program, a table row's worth at a time.
        for i in range(0, len(ents), nb):
            chunk = ents[i:i + nb]
            kb, vb = self._jit_export(
                self._padded_ids([e.block for e in chunk], 0), len(chunk))
            prefixes += [
                KVPrefix(tokens=e.tokens,
                         block_size=self.config.kv_block_size,
                         k_blocks=kb[:, j:j + 1].clone(),
                         v_blocks=vb[:, j:j + 1].clone())
                for j, e in enumerate(chunk)]
        return self._tiers.spill(prefixes)

    def _promote_tier_hits(self, hits: List[Any], dst_blocks: List[int],
                           handle: Optional[RequestHandle] = None) -> None:
        """Copy tier-resident chain links into fresh pool blocks through
        the adopt copy; the tier entries are popped only after it (the
        all-or-nothing contract)."""
        t_pro = time.time()
        kb = torch.cat([h.prefix.k_blocks[:, -1:] for h in hits], dim=1)
        vb = torch.cat([h.prefix.v_blocks[:, -1:] for h in hits], dim=1)
        self._staged_blocks = (kb, vb)
        self._jit_adopt(self._padded_ids(dst_blocks,
                                         self.config.pool_blocks),
                        len(dst_blocks))
        self._tiers.pop(hits)
        self._promoted_blocks += len(hits)
        if handle is not None:
            try:
                from ray_tpu_torch.util.tracing import record_span

                record_span("kv.promote", t_pro, time.time() - t_pro,
                            attrs={"blocks": len(hits)},
                            trace=self._phase_trace(handle))
            except Exception:
                pass  # telemetry must never break admission

    def call_on_scheduler(self, fn: Callable[[], Any],
                          timeout_s: float = 60.0) -> Any:
        """Run ``fn()`` on the scheduler thread between steps and return
        its result (or raise what it raised). Device state is touched only
        on that thread: a reader on another could gather the pool while a
        tick writes it. Deadlocks if called FROM the scheduler thread
        (call the target directly there)."""
        box: List[Any] = []
        ev = threading.Event()
        with self._lock:
            self._ctrl_q.append((fn, box, ev))
        self._work.set()
        if not ev.wait(timeout_s):
            raise TimeoutError("scheduler thread did not service the "
                               "control call (is run() driving it?)")
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]

    def _process_ctrl(self) -> bool:
        with self._lock:
            batch = list(self._ctrl_q)
            self._ctrl_q.clear()
        for fn, box, ev in batch:
            try:
                box.append(fn())
            except BaseException as e:          # relayed to the caller
                box.append(e)
            ev.set()
        return bool(batch)

    def export_prefix(self, tokens: Sequence[int],
                      max_blocks: Optional[int] = None) -> List[Any]:
        """Donor side of a peer pull: the longest pool + tier chain
        covering a prefix of ``tokens``, as one single-block KVPrefix per
        link (CPU tensors). Non-destructive: the donor keeps its copies.
        Must run on the scheduler thread; wrap it in
        :meth:`call_on_scheduler` from anywhere else. The pool links are
        gathered through the export program, which copies only the valid
        blocks of the padded row, where the reference gathers the whole
        row."""
        from ray_tpu_torch.serve.llm.kv_cache import KVPrefix

        if not self._paged or self._prefix is None:
            return []
        c = self.config
        bs = c.kv_block_size
        cap = len(tokens) // bs
        if max_blocks is not None:
            cap = min(cap, max_blocks)
        if cap <= 0:
            return []
        out: List[Any] = []
        hit = self._prefix.match(tokens, max_blocks=cap)
        if hit:
            n = min(len(hit), c.max_blocks_per_slot)
            kb, vb = self._jit_export(self._padded_ids(hit[:n], 0), n)
            for j in range(n):
                out.append(KVPrefix(
                    tokens=tuple(tokens[: (j + 1) * bs]), block_size=bs,
                    k_blocks=kb[:, j:j + 1].clone(),
                    v_blocks=vb[:, j:j + 1].clone()))
            self._allocator.free(hit)       # match increfed for us
        if self._tiers is not None and len(out) < cap:
            for h in self._tiers.lookup(tokens, bs, start_depth=len(out),
                                        max_blocks=cap - len(out)):
                out.append(h.prefix)
        return out

    def import_prefix(self, prefixes: Sequence[Any]) -> int:
        """Receiver side of a peer pull: park pulled chain links in the
        host tier; the pulling request's admission then promotes them
        through the cost model. Thread-safe (the tier manager locks): no
        scheduler hop needed.

        Each link is parked as a copy of its tensors: links pulled
        through the object store are views of the stored object (a
        ``get`` of a CPU tensor does not copy), and a parked view would
        hold that object's extent reader-pinned for as long as the tier
        keeps the link."""
        if self._tiers is None:
            return 0
        return self._tiers.spill([
            dataclasses.replace(p, k_blocks=p.k_blocks.clone(),
                                v_blocks=p.v_blocks.clone())
            for p in prefixes])

    def prefix_index_heads(self, max_heads: Optional[int] = None
                           ) -> List[Tuple[int, int]]:
        """What this replica can serve without prefilling, as
        ``(stable_hash, depth)`` chain links: pool-resident first
        (hottest), then tier residents, deduplicated and capped at
        ``serve_prefix_index_max_heads``. A Serve replica publishes
        this to the cluster-wide prefix index
        (``LLMServer._publish_index_loop``)."""
        from ray_tpu_torch._private.config import GlobalConfig

        if max_heads is None:
            max_heads = int(GlobalConfig.serve_prefix_index_max_heads)
        heads: List[Tuple[int, int]] = []
        seen: set = set()
        sources: List[List[Tuple[int, int]]] = []
        if self._prefix is not None:
            sources.append(self._prefix.snapshot_heads(max_heads))
        if self._tiers is not None:
            sources.append(self._tiers.stable_heads(max_heads))
        for src in sources:
            for h, d in src:
                if len(heads) >= max_heads:
                    return heads
                if h not in seen:
                    seen.add(h)
                    heads.append((h, d))
        return heads

    def preempt(self, slot: int) -> None:
        """Checkpoint a live slot and requeue it at its lane's head: its KV
        blocks are exported onto the handle (``handle.kv_state``), the
        slot and blocks are released, and the next admission resumes it
        through the adopt path, token for token."""
        if not self._paged:
            raise ValueError("preempt requires kv_layout='paged'")
        handle = self._slots[slot].handle
        if handle is None:
            raise ValueError(f"slot {slot} is not live")
        handle.kv_state = self._export_state(slot)
        self._release_slot(slot, donate=True)
        self._preempted += 1
        self._metrics.preemptions.inc(tags={"lane": handle.request.slo})
        self._requeue(handle, front=True)

    def _maybe_preempt(self) -> None:
        """Preemption policy behind the Hysteresis gate: when interactive
        requests wait and admission is starved (no free slot, or the pool
        refused an interactive admission last step), checkpoint the
        newest-admitted batch decode (the least sunk work per token
        emitted). The hold/cooldown gate keeps one tick of pressure from
        thrashing checkpoints."""
        if not self._paged:
            return
        with self._lock:
            waiting = len(self._queues["interactive"])
        if not waiting:
            self._preempt_gate.propose(0, 0)
            return
        batch_slots = [s for s in range(self.config.num_slots)
                       if self._slots[s].handle is not None
                       and self._slots[s].handle.request.slo == "batch"
                       and not self._slots[s].handle.request.prefill_only]
        pressure = bool(batch_slots) and (
            not self._free or self._admit_blocked)
        if self._preempt_gate.propose(0, 1 if pressure else 0) != 1:
            return
        victim = max(batch_slots,
                     key=lambda s: self._slots[s].handle.admitted_at)
        try:
            from ray_tpu_torch.observability.control import record_decision

            # The reference's call, kept as it is: it passes the reading
            # as a bare float and slot= as a keyword record_decision does
            # not take, so it raises and the except below drops the
            # decision, in both packages.
            record_decision(
                "llm_engine", "preempt",
                "interactive lane starved; checkpointing newest batch "
                "decode", float(waiting), slot=victim)
        except Exception:
            pass
        self.preempt(victim)

    def _process_cancels(self) -> None:
        """Tear down cancelled requests on the scheduler thread: live
        slots are released, requeued ones (a chunked prompt between
        chunks, a preempted checkpoint) are dropped."""
        with self._lock:
            if not self._cancelled:
                return
            ids, self._cancelled = self._cancelled, set()
            requeued = []
            for q in self._queues.values():
                for h in list(q):
                    if h.request_id in ids:
                        q.remove(h)
                        requeued.append(h)
        for h in requeued:
            self._finish_cancelled(h)
        for slot in range(self.config.num_slots):
            h = self._slots[slot].handle
            if h is not None and h.request_id in ids:
                self._release_slot(slot)
                self._finish_cancelled(h)

    # ----------------------------------------------------------- telemetry

    @staticmethod
    def _capture_trace(handle: RequestHandle) -> None:
        """Stamp the submitting thread's TraceContext onto the handle and
        allocate the llm.request span id, so the scheduler thread can
        parent spans with no ambient context of its own."""
        try:
            from ray_tpu_torch.util.tracing import (current_trace,
                                                    new_span_id)

            tc = current_trace()
            if tc is not None:
                handle.trace = tc
                handle.trace_span_id = new_span_id()
        except Exception:
            pass  # telemetry must never break submit

    @staticmethod
    def _phase_trace(handle: RequestHandle) -> Optional[Dict[str, Any]]:
        """Explicit trace fields for a phase or KV span of this request: a
        fresh span id parented under the handle's llm.request span."""
        if handle.trace is None:
            return None
        from ray_tpu_torch.util.tracing import new_span_id

        return {"trace_id": handle.trace.trace_id,
                "span_id": new_span_id(),
                "parent_span_id": handle.trace_span_id}

    def _record_finished(self, handle: RequestHandle) -> None:
        """Latency histograms and the request's lifecycle spans (queued ->
        prefill -> decode, under llm.request), carrying its captured trace
        identity explicitly (this runs on the scheduler thread). The TTFT
        observation links the trace id as the histogram's exemplar."""
        m = self._metrics
        e2e = handle.finished_at - handle.submitted_at
        trace_id = handle.trace.trace_id if handle.trace else None
        m.e2e.observe(e2e, trace_id=trace_id)
        if handle.ttft_s is not None:
            m.ttft.observe(handle.ttft_s, trace_id=trace_id)
        if handle.tpot_s is not None:
            m.tpot.observe(handle.tpot_s)
        m.tokens.inc(float(len(handle.tokens)))
        m.requests.inc(tags={"finish_reason": handle.finish_reason})
        try:
            from ray_tpu_torch.util.tracing import record_span

            # Monotonic offsets re-anchored on the wall-clock submit time.
            wall0 = handle.submitted_wall
            rid = handle.request_id
            admit = handle.admitted_at or handle.finished_at
            record_span("llm.queued", wall0, admit - handle.submitted_at,
                        attrs={"rid": rid}, trace=self._phase_trace(handle))
            if handle.first_token_at is not None:
                record_span(
                    "llm.prefill", wall0 + (admit - handle.submitted_at),
                    handle.first_token_at - admit, attrs={"rid": rid},
                    trace=self._phase_trace(handle))
                record_span(
                    "llm.decode",
                    wall0 + (handle.first_token_at - handle.submitted_at),
                    handle.finished_at - handle.first_token_at,
                    attrs={"rid": rid, "tokens": len(handle.tokens)},
                    trace=self._phase_trace(handle))
            req_trace = None
            if handle.trace is not None:
                # llm.request parents under the span active at submit.
                req_trace = {"trace_id": handle.trace.trace_id,
                             "span_id": handle.trace_span_id,
                             "parent_span_id": handle.trace.span_id}
            record_span("llm.request", wall0, e2e, attrs={
                "rid": rid, "tokens": len(handle.tokens),
                "finish_reason": handle.finish_reason}, trace=req_trace)
        except Exception:
            pass  # telemetry must never break the scheduler
        self._account_finished(handle, e2e)

    def _account_finished(self, handle: RequestHandle, e2e: float) -> None:
        """Close the request's cost meter. A "prefill" finish does not
        fold: its snapshot rides the hand-off next to the KVState and the
        decode side's meter absorbs it, so the migrated request lands on
        one ledger row."""
        meter = handle.meter
        if meter is None:
            return
        try:
            computed = handle.prefilled_tokens
            avoided = 0
            if not handle._adopted_submit:
                # Prefix and tier hits: prompt positions this engine never
                # prefilled. An adopted request's prompt was prefilled
                # (and credited) by the exporting engine.
                avoided = max(len(handle.request.prompt) - computed, 0)
            meter.note_prefill(computed, avoided)
            if handle.finish_reason == "prefill":
                if handle.ttft_s is not None:
                    meter.ttft_s = handle.ttft_s
                return
            from ray_tpu_torch.observability.accounting import fold_finished

            row = meter.finalize(
                handle.finish_reason or "unknown", len(handle.tokens),
                ttft_s=handle.ttft_s, tpot_s=handle.tpot_s, e2e_s=e2e)
            fold_finished(row)
        except Exception:
            pass  # accounting must never break the scheduler

    def _credit_decode(self, live, dt: float) -> None:
        """Split one decode/verify tick's wall time evenly across the
        slots live in it (an attribution, not a hardware counter). Runs
        before the emit loop, so a request finishing this tick is billed
        for it."""
        if not self._acct or dt <= 0 or len(live) == 0:
            return
        share = dt / len(live)
        for slot in live:
            h = self._slots[int(slot)].handle
            if h is not None and h.meter is not None:
                h.meter.note_chip("decode", share)

    def _update_gauges(self) -> None:
        """Refresh the gauges and push the prefix and tier counters'
        growth; host state only (no device sync)."""
        m = self._metrics
        active = int(self._active.sum())
        with self._lock:
            depths = {lane: len(q) for lane, q in self._queues.items()}
        m.queue_depth.set(float(sum(depths.values())))
        for lane, d in depths.items():
            m.lane_queue_depth.set(float(d), tags={"lane": lane})
        if self._spec_proposed:
            m.spec_accept_ratio.set(self._spec_accepted
                                    / self._spec_proposed)
        m.active_slots.set(float(active))
        m.batch_utilization.set(active / self.config.num_slots)
        if not self._paged:
            return
        m.kv_blocks_used.set(float(self._allocator.used_blocks))
        m.kv_blocks_free.set(float(self._allocator.free_blocks))
        if self._prefix is not None:
            cur = self._prefix.stats()
            seen = self._prefix_seen
            for field, ctr in (("hits", m.prefix_hits),
                               ("misses", m.prefix_misses),
                               ("hit_tokens", m.prefix_hit_tokens),
                               ("evictions", m.prefix_evictions)):
                d = cur[field] - seen[field]
                if d > 0:
                    ctr.inc(float(d))
                    seen[field] = cur[field]
        if self._tiers is not None:
            ts = self._tiers.stats()
            for tier in ("host", "store"):
                cur, seen = ts[tier], self._tier_seen[tier]
                for field, ctr in (("hits", m.prefix_tier_hits),
                                   ("misses", m.prefix_tier_misses),
                                   ("spills", m.prefix_tier_spills),
                                   ("promotes", m.prefix_tier_promotes)):
                    d = cur[field] - seen[field]
                    if d > 0:
                        ctr.inc(float(d), tags={"tier": tier})
                        seen[field] = cur[field]
                m.kv_tier_bytes.set(float(cur["bytes"]), tags={"tier": tier})
            m.kv_tier_bytes.set(float(self._allocator.used_bytes),
                                tags={"tier": "hbm"})

    # ------------------------------------------------------------ scheduling

    def step(self) -> bool:
        """One scheduler iteration: control calls, cancellations, the
        preemption policy, admission (prefill + first token per new slot;
        prefill_only requests finish here with their checkpoint), then one
        decode tick for every live slot, speculative when every live slot
        qualifies. Returns True if any work was done."""
        did_cancel = bool(self._cancelled)
        did_ctrl = self._process_ctrl()
        self._process_cancels()
        self._maybe_preempt()
        self._admit_blocked = False
        inserted = self._admit()
        if inserted:
            # First generated token per freshly prefilled slot, read
            # before the tick below overwrites it with the second.
            tok_host = self._tok.cpu().numpy()
            for slot, fresh in inserted:
                if not fresh:
                    continue
                if self._slots[slot].handle.request.prefill_only:
                    self._finish_prefill(slot, int(tok_host[slot]))
                else:
                    self._emit(slot, int(tok_host[slot]))
        if not self._active.any():
            self._update_gauges()
            return bool(inserted) or did_cancel or did_ctrl
        live = np.nonzero(self._active)[0]
        t_tick = time.monotonic()
        if self._spec_ready(live):
            toks_host, n_emit = self._spec_tick()
            self._credit_decode(live, time.monotonic() - t_tick)
            if self._acct:
                # A live slot's round proposed spec_k - 1 drafts and
                # accepted n_emit - 1.
                k_prop = self.config.spec_k - 1
                for slot in live:
                    h = self._slots[int(slot)].handle
                    if h is not None and h.meter is not None \
                            and int(n_emit[slot]) > 0:
                        h.meter.note_spec(k_prop, int(n_emit[slot]) - 1)
        else:
            toks_host = self._jit_tick()                  # [K, B]
            n_emit = np.full((self.config.num_slots,), toks_host.shape[0])
            self._credit_decode(live, time.monotonic() - t_tick)
        for slot in live:
            s = int(slot)
            for k in range(int(n_emit[s])):
                if self._slots[s].handle is None:
                    break          # finished earlier in the block; the
                    #                remaining tokens were speculative
                self._emit(s, int(toks_host[k, s]))
        self._update_gauges()
        return True

    def _spec_ready(self, live) -> bool:
        """A speculative round runs only when EVERY live slot qualifies:
        greedy sampling (acceptance compares argmaxes), draft cache
        seeded, and spec_k - 1 positions of headroom before the sequence
        limit. Mixed batches take the plain tick; correctness never
        depends on this gate, only decode speed."""
        if self._draft is None:
            return False
        if not bool(self._spec_ok[live].all()):
            return False
        if bool((self._temp[live] > 0).any()):
            return False
        pos_host = self._pos.cpu().numpy()
        return bool((pos_host[live] <= self.config.max_seq_len
                     - self.config.spec_k).all())

    def _spec_tick(self) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative round: (tokens [K, B], n_emit [B]) on the host;
        the caller emits tokens[0:n_emit[s], s] per slot."""
        t, n_emit = self._jit_spec()
        live = int((n_emit > 0).sum())
        self._spec_rounds += 1
        self._spec_proposed += (self.config.spec_k - 1) * live
        self._spec_accepted += int(n_emit.sum()) - live
        self._metrics.spec_proposed.inc(float((self.config.spec_k - 1)
                                              * live))
        self._metrics.spec_accepted.inc(float(int(n_emit.sum()) - live))
        return t, n_emit

    def run(self, stop_event: threading.Event,
            idle_wait_s: float = 0.02) -> None:
        """Scheduler loop for a background thread (one per engine)."""
        while not stop_event.is_set():
            if not self.step():
                self._work.clear()
                if not self.has_work():
                    self._work.wait(idle_wait_s)

    def drain(self, timeout: float = 300.0) -> None:
        """Step until queue and slots are empty (tests and offline use;
        do not mix with a run() thread)."""
        deadline = time.monotonic() + timeout
        while self.has_work():
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain")
            self.step()

    def warmup(self) -> None:
        """Run one request per prefill bucket (and the decode tick) before
        real traffic, so kernel builds and library handles are set up
        outside the first request's latency; with a draft, a second round
        runs the draft's inserts and the speculative round. The prefix
        cache is bypassed while warming (a hit would shrink the suffix to
        a smaller bucket). Synchronous; call before starting a run()
        thread."""
        prefix, self._prefix = self._prefix, None
        draft, self._draft = self._draft, None
        try:
            rounds = [None] if draft is None else [None, draft]
            for d in rounds:
                self._draft = d
                handles = [self.submit(Request(prompt=[1] * b,
                                               max_tokens=2))
                           for b in self.config.prefill_buckets]
                while any(h.finished_at is None for h in handles):
                    self.step()
        finally:
            self._prefix = prefix
            self._draft = draft

    # ------------------------------------------------------------ inspection

    @property
    def trace_count(self) -> int:
        """Number of engine programs traced so far (argument signatures
        of the tracked callables; the compile guard: bounded by the
        per-family budgets under any workload, len(buckets) inserts + 1
        tick, plus at most 1 export, 1 adopt, 1 spec round, and
        len(buckets) draft inserts when wired)."""
        n = self._jit_tick.traces + self._jit_insert.traces
        for name in ("_jit_export", "_jit_adopt", "_jit_spec",
                     "_jit_draft_insert"):
            fn = getattr(self, name, None)
            if fn is not None:
                n += fn.traces
        return n

    def stats(self) -> Dict[str, Any]:
        """Scheduler counters, the reference's sections with ``traces``
        and ``trace_count``. ``prefills`` counts inserts (chunks
        included); ``chunked_prefill``, ``kv.admission_waits`` and
        ``spec.draft_prefills`` are the port's own counters."""
        with self._lock:
            queued_by_lane = {lane: len(q)
                              for lane, q in self._queues.items()}
        traces = {"tick": self._jit_tick.traces,
                  "insert": self._jit_insert.traces}
        for name in ("export", "adopt", "spec", "draft_insert"):
            fn = getattr(self, f"_jit_{name}", None)
            if fn is not None:
                traces[name] = fn.traces
        out = {
            "num_slots": self.config.num_slots,
            "active_slots": int(self._active.sum()),
            "queued": sum(queued_by_lane.values()),
            "queued_by_lane": queued_by_lane,
            "completed": self._completed,
            "slot_reuses": self._slot_reuses,
            "prefills": self._prefills,
            "preempted": self._preempted,
            "kv_layout": self.config.kv_layout,
            "traces": traces,
            "trace_count": self.trace_count,
        }
        if self._paged:
            out["kv"] = dict(self._allocator.stats(),
                             block_size=self.config.kv_block_size,
                             admission_waits=self._block_waits)
            out["migration"] = {"blocks": self._migrated_blocks,
                                "bytes": self._migrated_bytes}
            out["chunked_prefill"] = {"prompts": self._chunked_prompts,
                                      "chunks": self._chunk_inserts}
            if self._prefix is not None:
                out["prefix_cache"] = self._prefix.stats()
            if self._tiers is not None:
                out["kv_tiers"] = dict(
                    self._tiers.stats(),
                    promoted_blocks=self._promoted_blocks,
                    promote_skips=self._promote_skips)
        if self._draft is not None or self._spec_rounds:
            out["spec"] = {
                "rounds": self._spec_rounds,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_ratio": (self._spec_accepted
                                 / max(self._spec_proposed, 1)),
                "draft_prefills": self._draft_prefills,
            }
        return out


def _tier_store_put(prefix):
    """Object-store leg of the KV hierarchy: demote a KVPrefix below
    host RAM. Raises when no cluster is attached — KVTierManager then
    counts the drop and moves on (a dropped block is a future
    recompute, never an error)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker_or_none

    if global_worker_or_none() is None:
        raise RuntimeError(
            "no cluster attached: object-store KV tier unavailable")
    return ray_tpu_torch.put(prefix)


def _tier_store_get(ref):
    """A demoted KVPrefix back from the store: its tensors are views of
    the stored object, which the promote only reads (into the pool)."""
    import ray_tpu_torch

    return ray_tpu_torch.get(ref, timeout=30.0)


def static_batch_generate(params, model_config, requests: List[Request],
                          batch_size: int, pad_to: int,
                          steps: Optional[int] = None,
                          warmup: bool = True):
    """The lockstep baseline the engine replaces: group requests in
    arrival order, pad prompts to ``pad_to``, decode ``steps`` (default:
    max(max_tokens)) per group with ``models.llama.generate``, truncate per
    request. Returns (outputs, per-batch seconds). Throughput baseline
    only: ``generate`` has no padding mask, so a prompt shorter than
    ``pad_to`` sees its pad tokens and its output differs from the
    unpadded result. Runs on the device the params live on."""
    from ray_tpu_torch.models.llama import generate

    dev = params["embed"].device
    steps = steps or max(r.max_tokens for r in requests)
    if warmup:                 # kernel builds and handles outside timings
        generate(params, torch.zeros((batch_size, pad_to), dtype=torch.long,
                                     device=dev), model_config, steps).cpu()
    outs: List[List[int]] = []
    batch_seconds: List[float] = []
    for i in range(0, len(requests), batch_size):
        group = requests[i:i + batch_size]
        toks = np.zeros((batch_size, pad_to), np.int64)
        for j, r in enumerate(group):
            toks[j, :len(r.prompt)] = np.asarray(r.prompt, np.int64)
        t0 = time.monotonic()
        out = generate(params, torch.from_numpy(toks).to(dev), model_config,
                       max_new_tokens=steps).cpu().numpy()
        batch_seconds.append(time.monotonic() - t0)
        for j, r in enumerate(group):
            outs.append(out[j, :r.max_tokens].tolist())
    return outs, batch_seconds
