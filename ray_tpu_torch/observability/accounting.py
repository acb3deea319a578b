"""Per-request cost accounting & SLO attainment for the serving tier:
the port's copy of ``ray_tpu/observability/accounting.py``.

The serving tier can trace a request hop-by-hop and meter the fleet in
aggregate, but neither answers "what did THIS request — or this tenant
— cost, and are we meeting the SLO we sold them?". Three cooperating
pieces answer it (the same measure-first shape as the reference's train
goodput plane):

- :class:`RequestMeter` — attached to every ``LLMEngine`` request,
  integrating over its lifetime: prefill tokens computed vs avoided
  (prefix/tier hits), decode tokens, speculative accept counts, KV
  **block-seconds** (block occupancy integrated over hold time — the
  HBM-rent number; monotone across preempt/resume and never
  double-counted), queue wait and chip-seconds per phase — stamped
  with ``{tenant, model, lane, trace_id}``. A meter survives KV
  migration: the prefill tier ships :meth:`RequestMeter.snapshot` next
  to the exported ``KVState`` and the decode tier absorbs it, so
  prefill chip-seconds land on the same ledger row.
- :class:`TenantLedger` — a bounded per-tenant accumulator the
  finished meters fold into. Cardinality is bounded by construction:
  past ``serve_accounting_max_tenants`` distinct tenants, new ones
  fold into the ``__other__`` rollup row — which is what makes the
  ``rtpu_serve_tenant_*_total{tenant}`` counters declared here safe
  against the ``metric-label-cardinality`` lint rule (the emit site IS
  the bounded fold).
- :class:`SLOTracker` — per-lane TTFT/TPOT attainment against the
  ``serve_slo_ttft_ms`` / ``serve_slo_tpot_ms`` config targets, with
  multi-window burn rate (fast ~1m / slow ~1h): the fast window
  catches a regression in about a minute, but only fires when the
  slow window is also consuming budget, so a one-blip spike never
  pages. A not-burning → burning transition yields one flag dict per
  episode — the GCS turns it into a typed ``SLO_BURN`` cluster event.

Rows publish to the GCS over the bounded accounting ring
(``report_serve_accounting`` / ``list_serve_accounting`` /
``serve_accounting_summary``) when the process has a worker attached,
and surface as ``util.state.serve_accounting()``; without one,
:func:`publish_serve_row` returns False, as the reference's does, and
rows reach the local tenant ledger, the metric surface and the row hooks
only. The whole plane is gated on ``serve_accounting_instrumentation``,
so the on/off delta can be priced.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# Chip-time phases a request is billed for. "prefill" covers the
# bucketed insert dispatch (and tier promotes) of its own admission;
# "decode" is its fair share (1/n_live) of each decode/verify tick it
# was live in. Scheduler-thread wall around the device programs — an
# attribution, not a hardware counter.
COST_PHASES = ("prefill", "decode")

# Rollup tenant key for overflow past serve_accounting_max_tenants.
OTHER_TENANT = "__other__"

_metrics = None
_ledger = None
_lock = threading.Lock()

# Test hooks: callables invoked with each finalized row folded in this
# process (the reconciliation self-check subscribes here).
_row_hooks: List[Callable[[Dict[str, Any]], None]] = []


class AccountingMetrics:
    """Metric surface of the accounting plane.

    The tenant-labelled counters are declared HERE (not in
    observability/serve.py) deliberately: every emit site routes
    through :class:`TenantLedger.fold`, whose ``__other__`` rollup
    bounds the tenant label set — the exemption contract of the
    ``metric-label-cardinality`` graftlint rule.
    """

    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Histogram

        cost_bounds = (0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                       1.0, 5.0, 15.0, 60.0)
        self.request_chip_seconds = Histogram(
            "serve_request_cost_chip_seconds", boundaries=cost_bounds,
            description="Per-request chip-seconds (prefill + decode "
                        "share), observed at request finish with the "
                        "request's trace id as the exemplar.")
        self.request_block_seconds = Histogram(
            "serve_request_cost_block_seconds", boundaries=cost_bounds,
            description="Per-request KV block-seconds (block occupancy "
                        "integrated over hold time — the HBM-rent "
                        "number).")
        self.tenant_tokens = Counter(
            "serve_tenant_tokens_total", tag_keys=("tenant",),
            description="Output tokens per tenant (bounded label set: "
                        "overflow tenants fold into __other__).")
        self.tenant_block_seconds = Counter(
            "serve_tenant_block_seconds_total", tag_keys=("tenant",),
            description="KV block-seconds per tenant — what each "
                        "tenant's requests rent in HBM block "
                        "occupancy.")
        self.tenant_chip_seconds = Counter(
            "serve_tenant_chip_seconds_total", tag_keys=("tenant",),
            description="Chip-seconds per tenant across prefill and "
                        "decode.")
        # The SLO attainment/burn gauges (rtpu_serve_slo_attainment_
        # ratio{lane}, rtpu_serve_slo_burn_rate{lane,window}) are NOT
        # declared here: the SLOTracker evaluates GCS-side, so the GCS
        # exports them natively in its /metrics exposition — same as
        # rtpu_nodes.


def accounting_metrics() -> AccountingMetrics:
    global _metrics
    with _lock:
        if _metrics is None:
            _metrics = AccountingMetrics()
        return _metrics


def accounting_enabled() -> bool:
    from ray_tpu_torch._private.config import GlobalConfig

    return bool(GlobalConfig.serve_accounting_instrumentation)


def _clean_tag(value: str) -> str:
    """Tag values must not contain ',' (the registry's tuple encoding)."""
    return str(value).replace(",", "_") or "default"


# -------------------------------------------------------------- meter

class RequestMeter:
    """Resource integrator for one serve request.

    Mutated on the engine scheduler thread (plus the submit call);
    a lock keeps ``snapshot()`` safe from the replica thread after
    completion. Block-seconds integrate over an explicit open interval
    (``_blocks_held`` since ``_held_since``): acquire/release close
    the running interval first, so preempt → resume cycles stay
    monotone and a double release cannot subtract time.
    """

    def __init__(self, tenant: str = "default", model: str = "",
                 lane: str = "interactive",
                 trace_id: Optional[str] = None,
                 request_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lk = threading.Lock()
        self.tenant = _clean_tag(tenant)
        self.model = str(model)
        self.lane = str(lane)
        self.trace_id = trace_id
        self.request_id = request_id
        self.queue_wait_s: Optional[float] = None
        self.prefill_tokens_computed = 0
        self.prefill_tokens_avoided = 0
        self.tokens_out = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.block_seconds = 0.0
        self.chip_seconds: Dict[str, float] = {p: 0.0 for p in COST_PHASES}
        self.migrations = 0         # absorbed prefill-side snapshots
        self.ttft_s: Optional[float] = None
        self.tpot_s: Optional[float] = None
        self.e2e_s: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.finished = False
        self._blocks_held = 0
        self._held_since: Optional[float] = None

    # --- block-seconds integration -------------------------------------
    def _settle(self, now: float) -> None:
        if self._blocks_held > 0 and self._held_since is not None:
            dt = max(now - self._held_since, 0.0)
            self.block_seconds += dt * self._blocks_held
        self._held_since = now if self._blocks_held > 0 else None

    def blocks_acquired(self, n: int, now: Optional[float] = None) -> None:
        if n <= 0:
            return
        now = self._clock() if now is None else now
        with self._lk:
            self._settle(now)
            self._blocks_held += int(n)
            self._held_since = now

    def blocks_released(self, n: int, now: Optional[float] = None) -> None:
        if n <= 0:
            return
        now = self._clock() if now is None else now
        with self._lk:
            self._settle(now)
            self._blocks_held = max(self._blocks_held - int(n), 0)
            self._held_since = now if self._blocks_held > 0 else None

    @property
    def blocks_held(self) -> int:
        return self._blocks_held

    # --- counters --------------------------------------------------------
    def note_queue_wait(self, seconds: float) -> None:
        with self._lk:
            self.queue_wait_s = (self.queue_wait_s or 0.0) \
                + max(float(seconds), 0.0)

    def note_prefill(self, computed: int, avoided: int) -> None:
        with self._lk:
            self.prefill_tokens_computed += max(int(computed), 0)
            self.prefill_tokens_avoided += max(int(avoided), 0)

    def note_spec(self, proposed: int, accepted: int) -> None:
        with self._lk:
            self.spec_proposed += max(int(proposed), 0)
            self.spec_accepted += max(int(accepted), 0)

    def note_chip(self, phase: str, seconds: float) -> None:
        if phase not in COST_PHASES:
            raise ValueError(f"unknown cost phase {phase!r} "
                             f"(want one of {COST_PHASES})")
        with self._lk:
            self.chip_seconds[phase] += max(float(seconds), 0.0)

    # --- migration -------------------------------------------------------
    def absorb(self, snapshot: Optional[Dict[str, Any]]) -> None:
        """Fold a prefill-side snapshot into this (decode-side) meter so
        the whole migrated request lands on ONE ledger row. Identity
        (tenant / trace id) prefers the originating side: the row must
        key by the trace id the router returned as ``x-trace-id``.
        Token counts are NOT absorbed — the decode handle's token list
        is seeded with the prefill-side tokens already, and absorbing
        them too would double-count."""
        if not snapshot:
            return
        with self._lk:
            if snapshot.get("trace_id"):
                self.trace_id = snapshot["trace_id"]
            if snapshot.get("tenant"):
                self.tenant = _clean_tag(snapshot["tenant"])
            if snapshot.get("model"):
                self.model = str(snapshot["model"])
            self.prefill_tokens_computed += int(
                snapshot.get("prefill_tokens_computed", 0))
            self.prefill_tokens_avoided += int(
                snapshot.get("prefill_tokens_avoided", 0))
            self.spec_proposed += int(snapshot.get("spec_proposed", 0))
            self.spec_accepted += int(snapshot.get("spec_accepted", 0))
            self.block_seconds += float(snapshot.get("block_seconds", 0.0))
            for phase in COST_PHASES:
                self.chip_seconds[phase] += float(
                    snapshot.get("chip_seconds", {}).get(phase, 0.0))
            if snapshot.get("queue_wait_s") is not None:
                self.queue_wait_s = (self.queue_wait_s or 0.0) \
                    + float(snapshot["queue_wait_s"])
            if snapshot.get("ttft_s") is not None:
                self.ttft_s = float(snapshot["ttft_s"])
            self.migrations += int(snapshot.get("migrations", 0)) + 1

    # --- lifecycle -------------------------------------------------------
    def finalize(self, finish_reason: str, tokens_out: int,
                 ttft_s: Optional[float] = None,
                 tpot_s: Optional[float] = None,
                 e2e_s: Optional[float] = None,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Close the integration (any open block interval settles) and
        return the row dict. Idempotent: a second finalize re-returns
        the same totals without re-integrating."""
        now = self._clock() if now is None else now
        with self._lk:
            if not self.finished:
                self._settle(now)
                self._blocks_held = 0
                self._held_since = None
                self.finished = True
                self.finish_reason = str(finish_reason)
                self.tokens_out = int(tokens_out)
                # A ttft absorbed from the prefill side wins: the first
                # token was sampled there.
                if self.ttft_s is None and ttft_s is not None:
                    self.ttft_s = float(ttft_s)
                if tpot_s is not None:
                    self.tpot_s = float(tpot_s)
                if e2e_s is not None:
                    self.e2e_s = float(e2e_s)
        return self.snapshot()

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view (picklable — this is what rides the disagg
        hand-off next to the KVState and what the GCS ring ingests)."""
        with self._lk:
            return {
                "tenant": self.tenant,
                "model": self.model,
                "lane": self.lane,
                "trace_id": self.trace_id,
                "request_id": self.request_id,
                "queue_wait_s": self.queue_wait_s,
                "prefill_tokens_computed": self.prefill_tokens_computed,
                "prefill_tokens_avoided": self.prefill_tokens_avoided,
                "tokens_out": self.tokens_out,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_accept_ratio": (
                    self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else None),
                "block_seconds": self.block_seconds,
                "chip_seconds": dict(self.chip_seconds),
                "chip_seconds_total": sum(self.chip_seconds.values()),
                "migrations": self.migrations,
                "ttft_s": self.ttft_s,
                "tpot_s": self.tpot_s,
                "e2e_s": self.e2e_s,
                "finish_reason": self.finish_reason,
                "finished": self.finished,
            }


# -------------------------------------------------------------- ledger

class TenantLedger:
    """Bounded per-tenant cost accumulator.

    ``fold()`` returns the canonical tenant key the row was booked
    under — the caller emits tenant-labelled counters with THAT key,
    which is how the metric label set stays bounded: at most
    ``max_tenants`` distinct tenants plus the ``__other__`` rollup.
    """

    _FIELDS = ("tokens", "block_seconds", "chip_seconds",
               "prefill_tokens_computed", "prefill_tokens_avoided",
               "queue_wait_s")

    def __init__(self, max_tenants: Optional[int] = None):
        if max_tenants is None:
            from ray_tpu_torch._private.config import GlobalConfig

            max_tenants = int(GlobalConfig.serve_accounting_max_tenants)
        self.max_tenants = max(int(max_tenants), 1)
        self._lk = threading.Lock()
        self._tenants: Dict[str, Dict[str, Any]] = {}

    def _slot_for(self, tenant: str) -> str:
        if tenant in self._tenants or \
                len(self._tenants) < self.max_tenants:
            return tenant
        return OTHER_TENANT

    def fold(self, row: Dict[str, Any]) -> str:
        tenant = _clean_tag(row.get("tenant") or "default")
        with self._lk:
            key = self._slot_for(tenant)
            t = self._tenants.setdefault(key, {
                "tenant": key, "requests": 0,
                **{f: 0.0 for f in self._FIELDS}})
            t["requests"] += 1
            t["tokens"] += float(row.get("tokens_out") or 0)
            t["block_seconds"] += float(row.get("block_seconds") or 0.0)
            t["chip_seconds"] += float(
                row.get("chip_seconds_total") or 0.0)
            t["prefill_tokens_computed"] += float(
                row.get("prefill_tokens_computed") or 0)
            t["prefill_tokens_avoided"] += float(
                row.get("prefill_tokens_avoided") or 0)
            t["queue_wait_s"] += float(row.get("queue_wait_s") or 0.0)
            t["last_trace_id"] = row.get("trace_id")
            t["last_lane"] = row.get("lane")
            return key

    def top(self, n: int) -> List[Dict[str, Any]]:
        """Top ``n`` tenants by chip-seconds (the cost currency)."""
        with self._lk:
            rows = sorted(self._tenants.values(),
                          key=lambda t: t["chip_seconds"], reverse=True)
            return [dict(r) for r in rows[:max(int(n), 0)]]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lk:
            return {k: dict(v) for k, v in self._tenants.items()}

    def __len__(self) -> int:
        with self._lk:
            return len(self._tenants)


def tenant_ledger() -> TenantLedger:
    """Process-local ledger singleton (one per serve replica process)."""
    global _ledger
    with _lock:
        if _ledger is None:
            _ledger = TenantLedger()
        return _ledger


def register_row_hook(fn: Callable[[Dict[str, Any]], None]) -> None:
    """Test hook: ``fn(row)`` runs for every row folded in this
    process (the reconciliation self-check subscribes here)."""
    _row_hooks.append(fn)


def unregister_row_hook(fn: Callable[[Dict[str, Any]], None]) -> None:
    try:
        _row_hooks.remove(fn)
    except ValueError:
        pass


def fold_finished(row: Dict[str, Any]) -> str:
    """Fold one finalized meter row: tenant ledger + the metric surface
    (cost histograms with the trace exemplar, bounded tenant counters)
    + fire-and-forget publish into the GCS accounting ring. Returns the
    canonical tenant key the row was booked under. Never raises —
    accounting must never break the scheduler."""
    key = tenant_ledger().fold(row)
    try:
        m = accounting_metrics()
        trace_id = row.get("trace_id")
        chip = float(row.get("chip_seconds_total") or 0.0)
        m.request_chip_seconds.observe(chip, trace_id=trace_id)
        m.request_block_seconds.observe(
            float(row.get("block_seconds") or 0.0), trace_id=trace_id)
        tags = {"tenant": key}
        tokens = float(row.get("tokens_out") or 0)
        if tokens:
            m.tenant_tokens.inc(tokens, tags=tags)
        if row.get("block_seconds"):
            m.tenant_block_seconds.inc(float(row["block_seconds"]),
                                       tags=tags)
        if chip:
            m.tenant_chip_seconds.inc(chip, tags=tags)
    except Exception:
        pass
    for fn in list(_row_hooks):
        try:
            fn(row)
        except Exception:
            pass
    publish_serve_row(row)
    return key


def publish_serve_row(row: Dict[str, Any]) -> bool:
    """Fire-and-forget report of one accounting row into the GCS ring
    (``report_serve_accounting``). Returns False (silently) outside a
    connected worker — a bare-process engine still gets local metrics
    and the local ledger."""
    try:
        from ray_tpu_torch._private.worker import global_worker_or_none

        w = global_worker_or_none()
        if w is None or getattr(w, "_dead", False):
            return False
        payload = dict(row)
        nid = w.node_id
        payload.setdefault(
            "node_id", nid.hex() if hasattr(nid, "hex") else nid)
        w.gcs.cast("report_serve_accounting", row=payload)
        return True
    except Exception:
        return False


# ------------------------------------------------------------ SLO targets

def _parse_lane_targets(spec: str, unit_scale: float = 1e-3
                        ) -> Dict[str, float]:
    """Parse ``"interactive=500,*=2000"`` (ms) into lane → seconds;
    a bare number applies to every lane (the ``*`` entry)."""
    out: Dict[str, float] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            lane, _, val = part.partition("=")
            lane = lane.strip() or "*"
        else:
            lane, val = "*", part
        try:
            out[lane] = float(val) * unit_scale
        except ValueError:
            continue
    return out


def slo_targets() -> Dict[str, Tuple[float, float]]:
    """Resolved per-lane (ttft_s, tpot_s) targets from config. Lanes
    without an explicit entry use the ``*`` default; a missing ``*``
    falls back to +inf (never violated)."""
    from ray_tpu_torch._private.config import GlobalConfig

    ttft = _parse_lane_targets(GlobalConfig.serve_slo_ttft_ms)
    tpot = _parse_lane_targets(GlobalConfig.serve_slo_tpot_ms)
    lanes = set(ttft) | set(tpot) | {"interactive", "batch"}
    lanes.discard("*")
    inf = float("inf")
    return {lane: (ttft.get(lane, ttft.get("*", inf)),
                   tpot.get(lane, tpot.get("*", inf)))
            for lane in lanes}


class SLOTracker:
    """Per-lane TTFT/TPOT attainment + multi-window burn rate.

    Pure host-side logic with an injectable clock (tests drive it with
    a fake). ``observe()`` returns a flag dict exactly once per
    not-burning → burning transition; the episode clears (and may
    re-fire later) once the fast burn drops below half the threshold —
    the same one-flag-per-episode discipline as the straggler
    detector."""

    _WINDOW_MAXLEN = 4096

    def __init__(self, targets: Optional[Dict[str, Tuple[float, float]]]
                 = None,
                 objective: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ray_tpu_torch._private.config import GlobalConfig

        self._targets = targets
        self.objective = float(
            GlobalConfig.serve_slo_objective
            if objective is None else objective)
        self.objective = min(max(self.objective, 0.0), 0.9999)
        self.fast_window_s = float(
            GlobalConfig.serve_slo_burn_fast_window_s
            if fast_window_s is None else fast_window_s)
        self.slow_window_s = float(
            GlobalConfig.serve_slo_burn_slow_window_s
            if slow_window_s is None else slow_window_s)
        self.burn_threshold = float(
            GlobalConfig.serve_slo_burn_threshold
            if burn_threshold is None else burn_threshold)
        self.min_samples = int(
            GlobalConfig.serve_slo_min_samples
            if min_samples is None else min_samples)
        self._clock = clock
        self._lk = threading.Lock()
        # lane -> deque[(t, ok)] covering the slow window (the fast
        # window is a suffix of it).
        self._obs: Dict[str, deque] = {}
        self._burning: Dict[str, bool] = {}

    def _lane_targets(self, lane: str) -> Tuple[float, float]:
        targets = self._targets if self._targets is not None \
            else slo_targets()
        inf = float("inf")
        if lane in targets:
            return targets[lane]
        return targets.get("*", (inf, inf))

    def observe(self, lane: str, ttft_s: Optional[float],
                tpot_s: Optional[float],
                now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        now = self._clock() if now is None else now
        lane = str(lane or "interactive")
        ttft_t, tpot_t = self._lane_targets(lane)
        ok = ((ttft_s is None or ttft_s <= ttft_t)
              and (tpot_s is None or tpot_s <= tpot_t))
        with self._lk:
            q = self._obs.setdefault(
                lane, deque(maxlen=self._WINDOW_MAXLEN))
            q.append((now, bool(ok)))
            self._prune(q, now)
            return self._evaluate(lane, now)

    def _prune(self, q: deque, now: float) -> None:
        horizon = now - self.slow_window_s
        while q and q[0][0] < horizon:
            q.popleft()

    def _window_stats(self, lane: str, window_s: float, now: float
                      ) -> Tuple[int, float]:
        q = self._obs.get(lane, ())
        horizon = now - window_s
        n = bad = 0
        for t, ok in reversed(q):
            if t < horizon:
                break
            n += 1
            if not ok:
                bad += 1
        return n, (bad / n if n else 0.0)

    def attainment(self, lane: str, window: str = "fast",
                   now: Optional[float] = None) -> Optional[float]:
        now = self._clock() if now is None else now
        window_s = self.fast_window_s if window == "fast" \
            else self.slow_window_s
        with self._lk:
            n, err = self._window_stats(lane, window_s, now)
        return None if n == 0 else 1.0 - err

    def burn_rate(self, lane: str, window: str = "fast",
                  now: Optional[float] = None) -> Optional[float]:
        """Error-budget burn: error_rate / (1 - objective). 1.0 means
        consuming budget exactly at the objective's allowance; a full
        outage at objective 0.99 burns at 100x."""
        att = self.attainment(lane, window, now)
        if att is None:
            return None
        return (1.0 - att) / (1.0 - self.objective)

    def burning(self, lane: str) -> bool:
        return bool(self._burning.get(str(lane)))

    def _evaluate(self, lane: str, now: float) -> Optional[Dict[str, Any]]:
        """Burn-state machine for one lane; caller holds the lock."""
        n_fast, err_fast = self._window_stats(
            lane, self.fast_window_s, now)
        _, err_slow = self._window_stats(lane, self.slow_window_s, now)
        budget = 1.0 - self.objective
        fast_burn = err_fast / budget
        slow_burn = err_slow / budget
        was = self._burning.get(lane, False)
        if was:
            if fast_burn < self.burn_threshold / 2.0:
                self._burning[lane] = False
            return None
        if (n_fast >= self.min_samples
                and fast_burn >= self.burn_threshold
                and slow_burn >= 1.0):
            self._burning[lane] = True
            ttft_t, tpot_t = self._lane_targets(lane)
            return {
                "lane": lane,
                "fast_burn": round(fast_burn, 3),
                "slow_burn": round(slow_burn, 3),
                "attainment_fast": round(1.0 - err_fast, 4),
                "attainment_slow": round(1.0 - err_slow, 4),
                "objective": self.objective,
                "ttft_target_s": ttft_t,
                "tpot_target_s": tpot_t,
                "window_fast_s": self.fast_window_s,
                "window_slow_s": self.slow_window_s,
            }
        return None

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Per-lane SLO view for the accounting summary: attainment and
        burn per window, burn state, targets."""
        now = self._clock() if now is None else now
        out: Dict[str, Any] = {}
        with self._lk:
            lanes = list(self._obs)
        for lane in lanes:
            ttft_t, tpot_t = self._lane_targets(lane)
            entry = {"ttft_target_s": ttft_t, "tpot_target_s": tpot_t,
                     "objective": self.objective,
                     "burning": self.burning(lane)}
            for window in ("fast", "slow"):
                att = self.attainment(lane, window, now)
                entry[f"attainment_{window}"] = att
                entry[f"burn_{window}"] = (
                    None if att is None
                    else (1.0 - att) / (1.0 - self.objective))
            out[lane] = entry
        return out


# --------------------------------------------------- reconciliation hook

class TokenReconciler:
    """Debug self-check: over a window, the sum of per-request meter
    token counts must equal the ``rtpu_serve_tokens_total`` delta —
    catching double-count/drop bugs in the fold path. Use as a context
    manager around a serve window, then assert ``.holds()``:

        with TokenReconciler() as rec:
            ...serve requests to completion...
        assert rec.holds(), rec.detail()

    Process-local by construction (``util.metrics.local_summary`` —
    zero-RPC), so it compares exactly the requests THIS process both
    metered and counted.
    """

    def __init__(self):
        self._rows: List[Dict[str, Any]] = []
        self._before = 0.0
        self._after: Optional[float] = None

    @staticmethod
    def _tokens_total() -> float:
        from ray_tpu_torch.util.metrics import local_summary

        rec = local_summary(["serve_tokens_total"]) \
            .get("serve_tokens_total")
        if not rec:
            return 0.0
        return float(sum(rec.get("data", {}).values()))

    def _on_row(self, row: Dict[str, Any]) -> None:
        self._rows.append(row)

    def __enter__(self) -> "TokenReconciler":
        self._before = self._tokens_total()
        register_row_hook(self._on_row)
        return self

    def __exit__(self, *exc) -> None:
        unregister_row_hook(self._on_row)
        self._after = self._tokens_total()

    @property
    def counter_delta(self) -> float:
        after = self._after if self._after is not None \
            else self._tokens_total()
        return after - self._before

    @property
    def meter_sum(self) -> float:
        return float(sum(r.get("tokens_out") or 0 for r in self._rows))

    def holds(self) -> bool:
        return abs(self.counter_delta - self.meter_sum) < 1e-9

    def detail(self) -> str:
        return (f"meter sum {self.meter_sum} vs counter delta "
                f"{self.counter_delta} over {len(self._rows)} rows")


def _reset_for_tests() -> None:
    """Drop process-local accounting state (ledger + hooks); metric
    objects persist (the registry aliases re-declarations)."""
    global _ledger
    with _lock:
        _ledger = None
    del _row_hooks[:]
