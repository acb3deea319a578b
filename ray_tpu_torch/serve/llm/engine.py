"""Continuous-batching LLM engine, dense KV layout: the PyTorch
counterpart of ``ray_tpu/serve/llm/engine.py``.

- A fixed pool of ``B = num_slots`` decode slots shares one KV cache
  ``[L, B, S, n_kv, head_dim]`` on the device, with per-slot last token and
  position tensors beside it.
- One decode tick advances every live slot together
  (``models.llama.decode_step`` with the slot-active mask: dead slots ride
  through the batch but leave their cache rows untouched), ``decode_block``
  steps per tick.
- Prefill runs at a small set of padded prompt-length buckets; the prompt's
  per-layer KV lands in the shared cache at the slot's index
  (insert-at-slot). With ``attn_impl="flash"`` and buckets of at least 128
  tokens every prefill goes through the flash kernel, once per layer.
- Slot eviction and recycling are host-side bookkeeping: EOS, a stop
  token or ``max_tokens`` free the slot and the next queued request
  prefills into it. Stale KV past a recycled slot's position is harmless:
  decode masks positions > pos and writes each position before it attends
  to it.

The reference's compiled programs donate the cache; here the scheduler
thread updates the cache and the token/position tensors in place. Only
that thread touches device state: ``submit`` and ``cancel`` (any thread)
only queue work under the lock.

Greedy decoding is token-identical to ``models.llama.generate`` on the same
params: bucket padding sits after the prompt, attention is causal, and the
first token comes from the logits at row ``prompt_len - 1``.

The paged layout, prefix cache, KV tiers, export/adopt, preemption,
speculative decoding and the metrics, tracing and accounting hooks come
with later slices of the port: paged KV, speculative decoding and disagg,
and the engine's observability.
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
    """Shapes of the engine's device state (fixed for its lifetime)."""

    num_slots: int = 8              # B: concurrent sequences in flight
    max_seq_len: int = 512          # S: shared KV cache length per slot
    # Padded prompt lengths; a prompt prefills at the smallest bucket that
    # holds it.
    prefill_buckets: Tuple[int, ...] = (32, 64, 128)
    eos_id: Optional[int] = None    # config-level end-of-sequence token
    # Decode steps per tick. >1 amortizes host round trips at the cost of
    # up to K-1 discarded tokens per finished slot (truncated host-side
    # at the same stop condition, so parity is unaffected).
    decode_block: int = 1
    kv_layout: str = "dense"        # "paged" is a later slice

    def __post_init__(self):
        if self.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if not self.prefill_buckets:
            raise ValueError("need at least one prefill bucket")
        if self.kv_layout == "paged":
            raise NotImplementedError(
                "kv_layout='paged' is not ported yet; it comes with the "
                "paged-KV slice (serve/llm/kv_cache.py)")
        if self.kv_layout != "dense":
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{self.kv_layout!r}")
        b = tuple(sorted(set(int(x) for x in self.prefill_buckets)))
        object.__setattr__(self, "prefill_buckets", b)
        if b[-1] > self.max_seq_len:
            raise ValueError(
                f"largest prefill bucket {b[-1]} exceeds max_seq_len "
                f"{self.max_seq_len}")


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
    # Admission lane: "interactive" drains before "batch".
    slo: str = "interactive"


class RequestHandle:
    """Host-side view of a submitted request; completion is an Event."""

    def __init__(self, request_id: int, request: Request):
        self.request_id = request_id
        self.request = request
        self.tokens: List[int] = []
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # "eos" | "stop" | "length" | "cancelled"
        self.finish_reason: Optional[str] = None
        self._done = threading.Event()
        self._engine: Optional["LLMEngine"] = None

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
    (``deployment.LLMServer`` runs one). ``params`` must already live on
    ``device`` (default: the card)."""

    def __init__(self, params: Any, model_config: Any,
                 engine_config: Optional[EngineConfig] = None,
                 rng_seed: int = 0, draft_params: Any = None,
                 draft_config: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        from ray_tpu_torch.models.llama import init_kv_cache

        if draft_params is not None or draft_config is not None:
            raise NotImplementedError(
                "speculative decoding (draft_params) is not ported yet; "
                "it comes with the speculative-decoding and disagg slice")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.model_config = model_config
        self.config = engine_config or EngineConfig()
        c = self.config
        B = c.num_slots

        # Device state, fixed shapes for the engine's whole lifetime.
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

    # ------------------------------------------------------ device programs

    def _tick_fn(self) -> np.ndarray:
        """``decode_block`` decode steps for all B slots. Inactive slots
        are computed but masked: no KV write, token/pos parked. Positions
        clamp at S-1 so a slot finishing mid-block never attends past rows
        it wrote itself; the host discards post-stop tokens. Returns the
        tokens [K, B] on the host."""
        from ray_tpu_torch.models.llama import decode_step

        S = self.config.max_seq_len
        active = torch.from_numpy(self._active.copy()).to(self.device)
        temp = torch.from_numpy(self._temp.copy()).to(self.device)
        tok, pos = self._tok, self._pos
        toks = []
        for _ in range(self.config.decode_block):
            logits, _ = decode_step(self.params, self._cache, tok, pos,
                                    self.model_config, active=active)
            nxt = _sample(logits, temp, self._gen)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, torch.clamp(pos + 1, max=S - 1), pos)
            toks.append(tok)
        self._tok, self._pos = tok, pos
        return torch.stack(toks).cpu().numpy()

    def _insert_fn(self, padded_prompt: np.ndarray, prompt_len: int,
                   slot: int, temperature: float) -> None:
        """Prefill one bucket-padded prompt, write its KV into the shared
        cache at ``slot`` (in place), and sample the first generated token
        from the logits at the last REAL prompt position."""
        from ray_tpu_torch.models.llama import lm_head_weight, prefill_kv

        c = self.model_config
        tokens = torch.from_numpy(padded_prompt).to(self.device)[None]
        hidden, ks, vs = prefill_kv(self.params, tokens, c)
        Pb = padded_prompt.shape[0]
        self._cache["k"][:, slot, :Pb] = ks[:, 0]
        self._cache["v"][:, slot, :Pb] = vs[:, 0]
        x_last = hidden[0, prompt_len - 1][None]
        logits = x_last.float() @ lm_head_weight(self.params, c).float()
        temp = torch.tensor([temperature], dtype=torch.float32,
                            device=self.device)
        self._tok[slot] = _sample(logits, temp, self._gen)[0]
        self._pos[slot] = prompt_len
        self._prefills += 1

    # ----------------------------------------------------------- submission

    def submit(self, request: Request) -> RequestHandle:
        c = self.config
        P = len(request.prompt)
        if P == 0:
            raise ValueError("empty prompt")
        if request.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if request.slo not in _LANES:
            raise ValueError(
                f"slo must be 'interactive' or 'batch', got "
                f"{request.slo!r}")
        if P > c.prefill_buckets[-1]:
            raise ValueError(
                f"prompt length {P} exceeds largest prefill bucket "
                f"{c.prefill_buckets[-1]}")
        handle = RequestHandle(next(self._ids), request)
        handle._engine = self
        with self._lock:
            self._queues[request.slo].append(handle)
        self._work.set()
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a submitted request. Queued handles finish here; live
        ones are marked and torn down by the scheduler thread."""
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
        handle._done.set()

    def has_work(self) -> bool:
        return (any(self._queues.values()) or bool(self._active.any())
                or bool(self._cancelled))

    # ------------------------------------------------------------ scheduling

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(n)  # pre-checked in submit()

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

    def _admit(self) -> List[int]:
        """Move queued requests into free slots (one prefill each);
        returns the slots filled this step."""
        inserted: List[int] = []
        while self._free:
            handle = self._pop_next()
            if handle is None:
                break
            if handle._done.is_set():
                continue   # cancelled while queued by a racing cancel()
            req = handle.request
            slot = self._free.popleft()
            P = len(req.prompt)
            padded = np.zeros((self._bucket_for(P),), np.int64)
            padded[:P] = np.asarray(req.prompt, np.int64)
            self._insert_fn(padded, P, slot, float(req.temperature))
            st = self._slots[slot]
            if st.uses:
                self._slot_reuses += 1
            st.uses += 1
            st.handle = handle
            self._active[slot] = True
            self._temp[slot] = req.temperature
            inserted.append(slot)
        return inserted

    def _release_slot(self, slot: int) -> None:
        st = self._slots[slot]
        st.handle = None
        self._active[slot] = False
        self._temp[slot] = 0.0
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
        # len(tokens); stop while it still fits in the shared cache.
        if reason is None and (len(req.prompt) + len(handle.tokens)
                               >= self.config.max_seq_len):
            reason = "length"
        if reason is not None:
            handle.finish_reason = reason
            handle.finished_at = now
            self._release_slot(slot)
            self._completed += 1
            handle._done.set()

    def _process_cancels(self) -> None:
        """Tear down cancelled live requests on the scheduler thread."""
        with self._lock:
            if not self._cancelled:
                return
            ids, self._cancelled = self._cancelled, set()
        for slot in range(self.config.num_slots):
            h = self._slots[slot].handle
            if h is not None and h.request_id in ids:
                self._release_slot(slot)
                self._finish_cancelled(h)

    def step(self) -> bool:
        """One scheduler iteration: cancellations, admission (prefill +
        first token per new slot), then one decode tick for every live
        slot. Returns True if any work was done."""
        did_cancel = bool(self._cancelled)
        self._process_cancels()
        inserted = self._admit()
        if inserted:
            # First generated token per new slot, read before the tick
            # below overwrites it with the second.
            tok_host = self._tok.cpu().numpy()
            for slot in inserted:
                self._emit(slot, int(tok_host[slot]))
        if not self._active.any():
            return bool(inserted) or did_cancel
        live = np.nonzero(self._active)[0]
        toks_host = self._tick_fn()                 # [K, B]
        for slot in live:
            s = int(slot)
            for k in range(toks_host.shape[0]):
                if self._slots[s].handle is None:
                    break          # finished earlier in the block —
                    #                remaining tokens were speculative
                self._emit(s, int(toks_host[k, s]))
        return True

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
        outside the first request's latency. Synchronous; call before
        starting a run() thread."""
        handles = [self.submit(Request(prompt=[1] * b, max_tokens=2))
                   for b in self.config.prefill_buckets]
        while any(h.finished_at is None for h in handles):
            self.step()

    # ------------------------------------------------------------ inspection

    def stats(self) -> Dict[str, Any]:
        """Scheduler counters. Unlike the reference there is no
        ``traces``/``trace_count``: eager PyTorch compiles no
        shape-specialised programs, so there is no compile budget to
        guard; ``prefills`` counts inserts instead."""
        with self._lock:
            queued_by_lane = {lane: len(q)
                              for lane, q in self._queues.items()}
        return {
            "num_slots": self.config.num_slots,
            "active_slots": int(self._active.sum()),
            "queued": sum(queued_by_lane.values()),
            "queued_by_lane": queued_by_lane,
            "completed": self._completed,
            "slot_reuses": self._slot_reuses,
            "prefills": self._prefills,
            "kv_layout": self.config.kv_layout,
        }


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
