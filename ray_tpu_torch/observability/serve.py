"""Serving instrumentation: the LLM engine's metric set, the port's copy
of ``ray_tpu/observability/serve.py``.

One process-wide singleton: engines in one process (a prefill and a
decode server side by side, say) share the registry entries, and the
serve controller (``serve_replicas``) and the LLM router
(``serve_router_*``) set theirs in their own processes; counters and
histograms aggregate across replicas on the GCS scrape side. Names,
tags, boundaries and descriptions are the reference's. Latency semantics
follow the serving literature:

- ``serve_queue_wait_seconds``: submit -> admitted into a decode slot.
- ``serve_ttft_seconds``: submit -> first generated token.
- ``serve_tpot_seconds``: mean per-output-token latency after the
  first token (one observation per finished request).
- ``serve_e2e_seconds``: submit -> finish.

Gauges carry the engine's live state: queue depth, active slots, and
batch utilization (active / num_slots — the share of the decode tick
doing real work; idle slots ride through it as masked rows), the paged
pool's blocks and the KV tiers' bytes. Counters carry the prefix-cache,
tier, migration, preemption and speculative events.
"""

from __future__ import annotations

import threading

_singleton = None
_lock = threading.Lock()


class ServeMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        lat = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
               10.0, 30.0, 60.0)
        self.ttft = Histogram(
            "serve_ttft_seconds", boundaries=lat,
            description="Time to first token (submit -> first token).")
        self.tpot = Histogram(
            "serve_tpot_seconds",
            boundaries=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0),
            description="Mean per-output-token latency after the first "
                        "token, one observation per request.")
        self.e2e = Histogram(
            "serve_e2e_seconds", boundaries=lat,
            description="Request end-to-end latency (submit -> finish).")
        self.queue_wait = Histogram(
            "serve_queue_wait_seconds", boundaries=lat,
            description="Submit -> admission into a decode slot.")
        self.queue_depth = Gauge(
            "serve_queue_depth",
            description="Requests waiting for a decode slot.")
        self.active_slots = Gauge(
            "serve_active_slots",
            description="Decode slots with a live request.")
        self.batch_utilization = Gauge(
            "serve_batch_utilization",
            description="active_slots / num_slots of the compiled "
                        "decode program.")
        self.tokens = Counter(
            "serve_tokens_total",
            description="Generated tokens emitted to requests.")
        self.requests = Counter(
            "serve_requests_total", tag_keys=("finish_reason",),
            description="Finished requests by finish reason.")
        self.slot_reuses = Counter(
            "serve_slot_reuses_total",
            description="Decode-slot recycles (continuous batching at "
                        "work).")
        self.request_timeouts = Counter(
            "serve_request_timeouts_total",
            description="Server-side waits that gave up before the "
                        "engine finished the request.")
        # Set by the serve controller (one process), so the per-pid
        # gauge split still yields one authoritative series per
        # deployment — the grafana replica-count panel reads this.
        self.replicas = Gauge(
            "serve_replicas", tag_keys=("deployment",),
            description="Live replicas per deployment, as reconciled "
                        "by the serve controller.")
        # Paged KV cache (serve/llm/kv_cache.py): pool occupancy and
        # prefix reuse. used + free == the engine's num_kv_blocks, so
        # used / (used + free) is the HBM-side KV utilization panel.
        self.kv_blocks_used = Gauge(
            "serve_kv_blocks_used",
            description="Paged-KV pool blocks currently referenced by a "
                        "live sequence or the prefix cache.")
        self.kv_blocks_free = Gauge(
            "serve_kv_blocks_free",
            description="Paged-KV pool blocks on the free list.")
        self.prefix_hits = Counter(
            "serve_prefix_cache_hits_total",
            description="Admissions that reused >= 1 cached prompt "
                        "block (their prefill was skipped).")
        self.prefix_misses = Counter(
            "serve_prefix_cache_misses_total",
            description="Admissions that found no cached prompt prefix.")
        self.prefix_hit_tokens = Counter(
            "serve_prefix_cache_hit_tokens_total",
            description="Prompt positions whose prefill was skipped via "
                        "the prefix cache.")
        self.prefix_evictions = Counter(
            "serve_prefix_cache_evictions_total",
            description="Prefix-cache entries evicted under pool "
                        "pressure (LRU).")
        # LLM router (serve/llm/router.py): per-replica load as seen by
        # the queue-depth probe, and where requests actually went.
        self.router_queue_depth = Gauge(
            "serve_router_queue_depth", tag_keys=("replica",),
            description="Engine queue depth per LLM replica as last "
                        "probed by the router.")
        self.router_requests = Counter(
            "serve_router_requests_total", tag_keys=("replica",),
            description="Requests forwarded per LLM replica by the "
                        "router's power-of-two-choices pick.")
        # Disaggregated serving (serve/llm/disagg): KV-block migration
        # between the prefill and decode pools, SLO lanes, and
        # speculative decoding.
        self.kv_migrated_blocks = Counter(
            "serve_kv_migrated_blocks_total",
            description="Paged KV blocks adopted into an engine's pool "
                        "from an exported checkpoint (prefill->decode "
                        "migration or preempt->resume).")
        self.kv_migrated_bytes = Counter(
            "serve_kv_migrated_bytes_total",
            description="Bytes of KV payload adopted into an engine's "
                        "pool from exported checkpoints.")
        self.lane_queue_depth = Gauge(
            "serve_lane_queue_depth", tag_keys=("lane",),
            description="Requests waiting for a decode slot, split by "
                        "SLO lane (interactive | batch).")
        self.preemptions = Counter(
            "serve_preemptions_total", tag_keys=("lane",),
            description="Live decodes checkpointed and requeued to free "
                        "a slot for the interactive lane, by the "
                        "victim's lane.")
        self.spec_proposed = Counter(
            "serve_spec_proposed_tokens_total",
            description="Draft tokens proposed by speculative-decode "
                        "rounds (spec_k - 1 per live slot per round).")
        self.spec_accepted = Counter(
            "serve_spec_accepted_tokens_total",
            description="Draft tokens accepted by the target verify "
                        "step (the bonus token per round is not "
                        "counted).")
        self.spec_accept_ratio = Gauge(
            "serve_spec_accept_ratio",
            description="Lifetime accepted / proposed draft tokens for "
                        "this engine (decode speedup is about "
                        "1 + ratio * (spec_k - 1)).")
        self.router_lane_requests = Counter(
            "serve_router_lane_requests_total", tag_keys=("lane", "pool"),
            description="Requests forwarded by the LLM router, split by "
                        "SLO lane and destination pool (monolithic | "
                        "prefill | decode).")
        # KV memory hierarchy (kv_cache.KVTierManager): evicted prefix
        # blocks spill HBM -> host RAM -> object store and are promoted
        # back through the adopt scatter instead of re-prefilling.
        self.prefix_tier_hits = Counter(
            "serve_prefix_tier_hits_total", tag_keys=("tier",),
            description="Tier lookups that found a spilled chain link "
                        "(one count per block), by tier (host | store).")
        self.prefix_tier_misses = Counter(
            "serve_prefix_tier_misses_total", tag_keys=("tier",),
            description="Tier lookups that found nothing at a depth, by "
                        "tier — the re-prefilled side of the hierarchy.")
        self.prefix_tier_spills = Counter(
            "serve_prefix_tier_spills_total", tag_keys=("tier",),
            description="KV blocks spilled INTO a tier (host: prefix "
                        "eviction or peer pull; store: host-budget "
                        "demotion).")
        self.prefix_tier_promotes = Counter(
            "serve_prefix_tier_promotes_total", tag_keys=("tier",),
            description="KV blocks promoted OUT of a tier back into the "
                        "HBM pool via the adopt scatter (their prefill "
                        "was skipped).")
        self.kv_tier_bytes = Gauge(
            "serve_kv_tier_bytes", tag_keys=("tier",),
            description="Resident KV bytes per tier of the memory "
                        "hierarchy (hbm | host | store).")
        # Cluster-wide prefix index (GCS report/lookup_prefix_index):
        # what cache-aware routing sees and how fresh it is.
        self.router_cache_hops = Counter(
            "serve_router_cache_decisions_total", tag_keys=("outcome",),
            description="Cache-aware routing decisions by outcome "
                        "(scored: index applied; held: index stale, "
                        "plain p2c; pulled: peer KV pull issued).")
        self.router_index_age = Gauge(
            "serve_router_index_age_seconds",
            description="Age of the LLM router's newest cluster "
                        "prefix-index view (staleness HOLD beyond "
                        "serve_prefix_index_ttl_s).")


def serve_metrics() -> ServeMetrics:
    global _singleton
    with _lock:
        if _singleton is None:
            _singleton = ServeMetrics()
        return _singleton
