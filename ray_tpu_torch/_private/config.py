"""Global runtime config registry, the port's copy of the reference's
(``ray_tpu/_private/config.py``).

Equivalent in role to the reference's `src/ray/common/ray_config_def.h` macro
table: a single source of truth of typed, defaulted knobs, each overridable by
an environment variable ``RAY_TPU_<name>`` on any process, or by a
``_system_config`` dict passed to ``ray_tpu_torch.init`` on the head node and
propagated to every other process through the GCS at registration time. The
names and defaults are the reference's, the serve knobs included. Only the
settings that a module of the port reads are defined: the rest of the
reference's table comes with the module that reads it (the
device-profile, RLlib and Data slices).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


@dataclass
class _ConfigEntry:
    name: str
    type: type
    default: Any
    doc: str = ""


_REGISTRY: Dict[str, _ConfigEntry] = {}


def _define(name: str, type_: type, default: Any, doc: str = "") -> None:
    _REGISTRY[name] = _ConfigEntry(name, type_, default, doc)


# ---------------------------------------------------------------------------
# Config table. Names intentionally parallel the reference's where the knob is
# the same concept (e.g. max_direct_call_object_size ~ ray_config_def.h:206).
# ---------------------------------------------------------------------------

# --- object store / objects ---
_define("max_direct_call_object_size", int, 100 * 1024,
        "Objects <= this many bytes are inlined in task replies / the "
        "in-process memory store instead of the shared-memory store.")
_define("object_store_memory", int, 2 * 1024 * 1024 * 1024,
        "Default per-node shared-memory object store capacity in bytes.")
_define("object_manager_chunk_size", int, 5 * 1024 * 1024,
        "Chunk size for node-to-node object transfer.")
_define("rpc_put_max_bytes", int, 512 * 1024,
        "Owner puts <= this many bytes travel inside a single pipelined "
        "put_object RPC; larger ones are written into the shared arena "
        "mapping directly (create + client memcpy + seal).")
_define("async_put_max_inflight", int, 32,
        "Max owner puts pipelined on the io loop before put() blocks.")

# --- scheduling ---
_define("scheduler_top_k_fraction", float, 0.2,
        "Hybrid scheduling policy considers the top max(1, k*n_nodes) nodes.")
_define("scheduler_spread_threshold", float, 0.5,
        "Critical resource utilization below which the hybrid policy packs "
        "onto the local/first node instead of spreading.")
_define("worker_lease_timeout_ms", int, 30000, "")
_define("actor_unreachable_timeout_s", float, 120.0,
        "How long the actor delivery layer keeps resending the same "
        "frames (same seqs — dedup'd by the worker) to an actor that is "
        "ALIVE with an unchanged incarnation but unreachable, before "
        "surfacing ActorUnavailableError. Oversubscribed hosts can "
        "CPU-starve healthy workers past many connect timeouts.")
_define("max_workers_per_node", int, 0,
        "Cap on pooled workers per node; 0 means #CPUs.")
_define("worker_pool_idle_ttl_s", float, 600.0,
        "Idle pooled workers beyond the soft limit are reaped after this.")

# --- fault tolerance ---
_define("health_check_period_ms", int, 1000, "")
_define("raylet_report_resources_period_ms", int, 100,
        "How often a raylet pushes its resource view to the GCS. Drives how "
        "fast spillback decisions see remote availability (reference: "
        "raylet_report_resources_period_milliseconds).")
_define("health_check_failure_threshold", int, 5,
        "Consecutive missed health checks before a node is marked dead.")
_define("task_max_retries_default", int, 3, "")
_define("borrow_pending_ttl_s", float, 600.0,
        "How long a serialized-out ref stays pinned waiting for its "
        "recipient to register as a borrower. The backstop that turns "
        "lost-message races into a bounded delay instead of a leak.")
_define("actor_max_restarts_default", int, 0, "")

# --- workers ---
_define("worker_startup_batch", int, 4, "Prestarted workers per node.")
_define("object_store_backend", str, "native",
        "Per-node store backend: 'native' (C++ arena allocator, "
        "native/arena_store.cpp) or 'files' (file-per-object fallback).")
_define("worker_pool_min_idle", int, 2,
        "Keep at least this many warm workers per active job so actor "
        "creation after kills never pays a Python cold start "
        "(reference: worker_pool.cc prestart).")

# --- memory monitor / OOM (reference: memory_monitor.h:52,
# worker_killing_policy.h:34; threshold default mirrors
# RAY_memory_usage_threshold) ---
_define("memory_usage_threshold", float, 0.95,
        "Node memory fraction above which the raylet OOM-kills a leased "
        "task worker (retriable-newest-first policy).")
_define("memory_monitor_refresh_ms", int, 250,
        "Memory monitor poll period; 0 disables OOM killing.")
_define("memory_monitor_test_usage_path", str, "",
        "Test hook: read the usage fraction from this file instead of "
        "psutil/cgroup.")
_define("memory_preempt_threshold", float, 0.85,
        "Node memory fraction above which the raylet preemptively "
        "retires the largest leased task worker (PREEMPT_RESCHEDULE; "
        "the task retries via the normal lease-return path) before the "
        "kill threshold is reached. Must sit below "
        "memory_usage_threshold; 0 disables preemption.")
_define("memory_preempt_cooldown_s", float, 5.0,
        "Minimum spacing between memory preemptions on one node — one "
        "retirement must get a chance to free memory before the next "
        "verdict.")

# --- control plane and serve ---
_define("ctrl_metrics_staleness_s", float, 10.0,
        "A controller reading whose newest source push is older than "
        "this holds (no action) instead of acting — 'the gauge is low' "
        "and 'the gauge stopped updating' must never be conflated.")
_define("ctrl_decisions_buffer_size", int, 2_000,
        "Ring buffer capacity of the GCS control-decision log "
        "(GET /api/controller).")
_define("serve_autoscale_interval_s", float, 2.0,
        "Period of the serve controller's autoscale policy loop (each "
        "tick refreshes the MetricsHub and re-evaluates desired "
        "replicas; jittered ±20% to avoid thundering herds).")
_define("serve_autoscale_cooldown_s", float, 5.0,
        "Minimum spacing between scale actions on one deployment, on "
        "top of the up/downscale hold delays.")
_define("serve_kv_block_size", int, 16,
        "Default paged-KV block size (rows per HBM block) for serve "
        "LLM engines built without an explicit kv_block_size.")
_define("serve_router_probe_interval_s", float, 1.0,
        "Period of the LLM router's per-replica queue-depth probe; a "
        "stalled replica sheds traffic within about one period.")
_define("serve_preempt_hold_s", float, 0.25,
        "How long the interactive lane must stay starved (queued "
        "request + no admissible slot) before the engine's Hysteresis "
        "gate lets it checkpoint a batch decode — transient pressure "
        "from one full tick never thrashes checkpoints.")
_define("serve_preempt_cooldown_s", float, 1.0,
        "Minimum spacing between batch-decode preemptions on one "
        "engine (each checkpoint costs an export + a later re-adopt).")
_define("serve_spec_k", int, 4,
        "Speculative decoding depth for serve LLM engines built with a "
        "draft model: spec_k - 1 draft proposals verified per round, "
        "so each verify step emits 1..spec_k tokens.")
_define("serve_kv_host_tier_bytes", int, 256 * 1024 * 1024,
        "Host-RAM budget of the KV memory hierarchy's middle tier "
        "(serve/llm/kv_cache.KVTierManager): evicted prefix blocks "
        "spill here instead of vanishing; overflow demotes to the "
        "object store (or is dropped, counted, when no cluster is "
        "attached).")
_define("serve_kv_adopt_cost_fixed_ms", float, 2.0,
        "PromoteCostModel: fixed cost of one tier->HBM promote "
        "dispatch (host staging + the adopt scatter launch), "
        "independent of block count.")
_define("serve_kv_adopt_cost_per_block_ms", float, 0.1,
        "PromoteCostModel: marginal cost per promoted KV block "
        "(host->device transfer of one block's rows).")
_define("serve_kv_prefill_cost_per_token_ms", float, 0.05,
        "PromoteCostModel: prefill cost per prompt token — the "
        "recompute side of the promote-vs-recompute crossover. Short "
        "suffixes recompute; long ones re-adopt.")
_define("serve_prefix_index_publish_interval_s", float, 2.0,
        "Period of each LLM replica's prefix-index publish (hash-chain "
        "heads + tier residency -> GCS report_prefix_index).")
_define("serve_prefix_index_ttl_s", float, 15.0,
        "GCS prefix-index entry lifetime: a replica that stops "
        "publishing drops out of cache-aware routing after this long "
        "(and the router HOLDs to plain p2c per the staleness "
        "discipline when its whole view is older than this).")
_define("serve_prefix_index_max_heads", int, 512,
        "Cap on hash-chain heads one replica publishes per index "
        "report (hottest first; the index is a routing hint, not a "
        "directory).")
_define("serve_router_cache_weight", float, 0.25,
        "Cache-aware p2c: score = load - weight * expected prefix-hit "
        "blocks. Keep < 1 so affinity breaks near-ties without "
        "outweighing whole queued requests (BENCH llama_serve_kv_"
        "tiering: weight 1.0 saturates the hot family's replica and "
        "queue wait eats the prefill savings). 0 recovers plain "
        "queue-depth p2c.")
_define("serve_peer_pull_min_blocks", int, 4,
        "Minimum expected-hit advantage (in blocks) a peer must hold "
        "over the chosen replica before the router pulls KV blocks "
        "from it instead of letting the replica recompute.")
_define("serve_accounting_instrumentation", bool, True,
        "Per-request cost accounting on serve LLM engines "
        "(observability.accounting.RequestMeter): prefill tokens "
        "computed vs avoided, decode tokens, KV block-seconds, "
        "chip-seconds per phase, folded into the tenant ledger and "
        "published to the GCS accounting ring. Off = the unmetered "
        "engine; the serve_accounting_overhead bench prices the delta.")
_define("serve_accounting_buffer_size", int, 4096,
        "Bound on the GCS serve-accounting ring "
        "(report_serve_accounting / list_serve_accounting rows across "
        "all replicas).")
_define("serve_accounting_top_n", int, 8,
        "How many tenants the accounting summaries rank by cost "
        "(serve_accounting_summary / GET /api/accounting top lists).")
_define("serve_accounting_max_tenants", int, 64,
        "Bound on distinct tenant rows a TenantLedger holds; overflow "
        "tenants fold into the '__other__' rollup row, which also caps "
        "the cardinality of the rtpu_serve_tenant_* counter label.")
_define("serve_slo_ttft_ms", str, "interactive=500,*=2000",
        "Per-lane TTFT targets (ms) for SLO attainment: "
        "'lane=ms,...' with '*' as the default lane. A bare number "
        "applies to every lane.")
_define("serve_slo_tpot_ms", str, "interactive=200,*=1000",
        "Per-lane TPOT (per-output-token) targets in ms; same format "
        "as serve_slo_ttft_ms.")
_define("serve_slo_objective", float, 0.99,
        "Fraction of requests per lane that must meet their TTFT/TPOT "
        "targets; 1 - objective is the error budget the burn rate is "
        "measured against.")
_define("serve_slo_burn_fast_window_s", float, 60.0,
        "Fast window of the multi-window SLO burn-rate evaluation "
        "(catches sharp regressions within about a minute).")
_define("serve_slo_burn_slow_window_s", float, 3600.0,
        "Slow window of the SLO burn-rate evaluation (the fast window "
        "only fires when the slow window is also consuming budget, so "
        "a one-blip spike never pages).")
_define("serve_slo_burn_threshold", float, 10.0,
        "Fast-window burn rate at or above which (with the slow "
        "window also >= 1.0) an SLO_BURN cluster event fires; the "
        "episode clears when the fast burn drops below half this.")
_define("serve_slo_min_samples", int, 3,
        "Minimum fast-window observations before a lane's burn rate "
        "is trusted enough to fire SLO_BURN.")

# --- logging / events ---
_define("task_events_buffer_size", int, 100_000,
        "Ring buffer capacity of task lifecycle events kept on the head "
        "(reference: gcs task manager ring buffer).")
_define("cluster_events_buffer_size", int, 10_000,
        "Ring buffer capacity of the GCS ClusterEventLog (typed "
        "failure-forensics events; reference: gcs event export).")
_define("worker_exit_tail_lines", int, 20,
        "How many trailing log lines the raylet captures from a dead "
        "worker's stdout/stderr files for death-error enrichment.")
_define("metrics_report_interval_s", float, 2.0,
        "Flush cadence of user-defined ray_tpu_torch.util.metrics to the GCS "
        "(reference: metrics_report_interval_ms).")
_define("trace_sample_rate", float, 0.01,
        "Tail-sampling keep probability for fast, clean traces in the "
        "GCS TraceStore. Slow (>= trace_keep_threshold_s) and errored "
        "traces are always kept — the decision runs at trace "
        "completion, when the whole trace is visible.")
_define("trace_keep_threshold_s", float, 0.5,
        "Root-span duration at or above which a completed trace is "
        "always kept regardless of trace_sample_rate.")
_define("trace_store_maxlen", int, 512,
        "LRU capacity of kept traces in the GCS TraceStore.")
_define("trace_pending_max", int, 2048,
        "Bound on in-flight (rootless) traces accumulating in the "
        "TraceStore; oldest-first eviction, so a crashed hop that "
        "never sends its root span cannot leak memory.")
_define("sched_phase_instrumentation", bool, True,
        "Record per-task scheduling-phase timestamps (PENDING -> "
        "LEASE_GRANTED -> WORKER_STARTED -> ARGS_READY -> RUNNING) "
        "through the lease protocol: task-event ring entries, segmented "
        "timeline submit arrows, and the rtpu_sched_phase_seconds{phase} "
        "histogram. Off = only the PENDING/RUNNING/FINISHED skeleton.")
_define("profiler_default_hz", int, 100,
        "Default sampling rate of the wall-clock stack profiler "
        "(observability.profiling.StackSampler / util.state.profile).")
_define("profiler_max_unique_stacks", int, 10_000,
        "Bound on distinct (thread, stack) keys one StackSampler run "
        "retains; overflowing samples are counted as dropped instead of "
        "allocated, so profiling can never OOM the target.")
_define("profiler_max_duration_s", float, 60.0,
        "Cap on a single worker-side profile RPC window (long profiles "
        "are chunked by the util.state.profile client).")
_define("tpu_profile_dir", str, "",
        "Directory for util.state.tpu_profile device traces (Chrome trace "
        "JSON from torch.profiler, CPU and CUDA activities); defaults "
        "under the system temp dir.")

# --- train goodput and the GCS step matrix (observability/goodput.py) ---
_define("train_goodput_instrumentation", bool, True,
        "Per-step train phase ledger + goodput accounting "
        "(observability.goodput): rtpu_train_step_phase_seconds{phase} "
        "histograms, the rtpu_train_goodput_ratio gauge, train.step "
        "spans, and step-row heartbeats into the GCS step matrix "
        "(report_train_steps). Off = the uninstrumented step loop.")
_define("train_steps_buffer_size", int, 4096,
        "Bound on the GCS train-step matrix ring (report_train_steps/"
        "list_train_steps rows across all workers).")
_define("train_straggler_threshold", float, 1.5,
        "A train worker whose windowed mean step time exceeds the pod "
        "median by this factor is flagged with a TRAIN_STRAGGLER "
        "cluster event naming its dominant phase.")
_define("train_straggler_window", int, 8,
        "Per-worker window (steps) of the straggler detector's means; "
        "also the re-flag suppression distance (one event per "
        "straggler episode, not one per step).")
_define("train_stall_heartbeats", int, 3,
        "A train worker missing this many expected step-report "
        "heartbeats (expected interval = its recent median step time) "
        "is declared stalled: TRAIN_STALL event + automatic "
        "dump_stacks capture of the worker attached to the event.")
_define("train_stall_min_timeout_s", float, 10.0,
        "Floor on the stall watchdog timeout, so fast steps (ms-class "
        "on the CPU) don't declare a stall on scheduler jitter.")
_define("train_stall_check_interval_s", float, 1.0,
        "Period of the GCS train stall watchdog sweep.")

# --- the program plane (observability/xla.py, observability/jit.py) ---
_define("xla_attribution_instrumentation", bool, True,
        "Per-program cost attribution on tracked_jit wrappers "
        "(observability.xla.ProgramRegistry): FLOP, byte and "
        "transcendental counts captured on a signature's first call, "
        "MFU/MBU + roofline verdicts from sampled walls, rows into the GCS "
        "report_xla_programs ring, and the PERF_REGRESSION sentinel. "
        "Off = plain trace/compile counters only.")
_define("xla_wall_sample_every", int, 64,
        "Sample every Nth steady-state call of a tracked function with "
        "torch.cuda.synchronize() to measure an honest execution wall "
        "(feeds MFU/MBU). 0 disables wall sampling: no fence ever runs on "
        "the hot path; rows then carry cost/memory counts but no "
        "utilization ratios.")
_define("xla_programs_buffer_size", int, 4096,
        "Bound on the GCS program ring (report_xla_programs / "
        "list_xla_programs rows across all processes).")
_define("xla_regression_ratio", float, 1.5,
        "Regression sentinel threshold: a new program whose flops or peak "
        "device bytes, or a sampled wall whose EWMA, exceeds the "
        "function's baseline by this factor fires one PERF_REGRESSION "
        "cluster event per drifted-dimension episode (re-arms when the "
        "dimension returns within the ratio). 0 disables the sentinel.")
_define("xla_comm_bound_fraction", float, 0.5,
        "Exposed-collective fraction of a sampled program wall above which "
        "the roofline verdict is 'comm-bound' instead of compute-/memory-"
        "bound (fed by the split-phase overlap accounting in "
        "observability.collective).")
_define("jit_recompile_warn_budget", int, 8,
        "Default trace budget of observability.tracked_jit wrappers: a "
        "tracked function that traces more argument signatures than this "
        "warns RecompileWarning once. Explicit trace_budget= overrides per "
        "wrapper; 0 disables the warning.")



class _Config:
    """Resolved view: env var > system_config > default."""

    def __init__(self):
        self._system_config: Dict[str, Any] = {}

    def initialize(self, system_config: Dict[str, Any] | None) -> None:
        if not system_config:
            return
        for key, value in system_config.items():
            if key not in _REGISTRY:
                raise ValueError(f"Unknown system config key: {key}")
            self._system_config[key] = value

    def get(self, name: str) -> Any:
        entry = _REGISTRY[name]
        env_val = os.environ.get(_ENV_PREFIX + name)
        if env_val is not None:
            return _PARSERS[entry.type](env_val)
        if name in self._system_config:
            return entry.type(self._system_config[name])
        return entry.default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None

    def dump_system_config(self) -> str:
        return json.dumps(self._system_config)

    def load_system_config(self, payload: str) -> None:
        self._system_config.update(json.loads(payload))


GlobalConfig = _Config()
