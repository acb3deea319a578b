"""Grafana dashboard generator (reference:
`dashboard/modules/metrics/grafana_dashboard_factory.py` +
`default_dashboard_panels.py` — auto-generated dashboards over the
Prometheus metrics the cluster exports).

`generate_default_dashboard()` returns a Grafana dashboard JSON whose
panels query the `rtpu_*` series served by the GCS `/metrics` endpoint;
`write_dashboard(path)` drops it where Grafana provisioning can pick it
up.

The port's copy is the reference's dashboard, panel for panel, with the
accelerator panel over ``resource="GPU"`` (the port leases its cards as
``GPU``); its title, uid and tags stay the reference's, so one Grafana
provisioning serves either package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

_PANELS: List[Dict[str, str]] = [
    {"title": "Alive nodes", "expr": 'rtpu_nodes{state="ALIVE"}',
     "unit": "short"},
    {"title": "Actors by state", "expr": "rtpu_actors",
     "legend": "{{state}}", "unit": "short"},
    {"title": "Task events by state",
     "expr": "rate(rtpu_tasks_events_total[5m])",
     "legend": "{{state}}", "unit": "short"},
    {"title": "Cluster events rate",
     "expr": "rate(rtpu_cluster_events_total[5m])",
     "legend": "{{type}}/{{severity}}", "unit": "short"},
    {"title": "CPU available vs total",
     "expr": 'rtpu_resource_available{resource="CPU"}',
     "expr_b": 'rtpu_resource_capacity{resource="CPU"}',
     "unit": "short"},
    {"title": "GPU available vs total",
     "expr": 'rtpu_resource_available{resource="GPU"}',
     "expr_b": 'rtpu_resource_capacity{resource="GPU"}',
     "unit": "short"},
    {"title": "Object store used",
     "expr": 'rtpu_resource_capacity{resource="object_store_memory"} - '
             'rtpu_resource_available{resource="object_store_memory"}',
     "unit": "bytes"},
    {"title": "Placement groups",
     "expr": "rtpu_placement_groups", "legend": "{{state}}",
     "unit": "short"},
    # --- serving / JIT / device telemetry (observability plane) ---
    {"title": "Serve TTFT p50/p99",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_serve_ttft_seconds_bucket[5m]))',
     "expr_b": 'histogram_quantile(0.99, '
               'rate(rtpu_serve_ttft_seconds_bucket[5m]))',
     "unit": "s"},
    {"title": "Serve e2e latency p50/p99",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_serve_e2e_seconds_bucket[5m]))',
     "expr_b": 'histogram_quantile(0.99, '
               'rate(rtpu_serve_e2e_seconds_bucket[5m]))',
     "unit": "s"},
    {"title": "Serve tokens/sec",
     "expr": "rate(rtpu_serve_tokens_total[1m])", "unit": "short"},
    {"title": "Serve queue depth / active slots",
     "expr": "rtpu_serve_queue_depth",
     "expr_b": "rtpu_serve_active_slots", "unit": "short"},
    {"title": "JIT retraces (recompiles)",
     "expr": "rate(rtpu_jit_traces_total[5m])",
     "legend": "{{fn}}", "unit": "short"},
    {"title": "JIT compile time",
     "expr": "rate(rtpu_jit_compile_seconds_sum[5m])",
     "legend": "{{fn}}", "unit": "s"},
    {"title": "Device HBM used vs total",
     "expr": "rtpu_device_hbm_used_bytes",
     "expr_b": "rtpu_device_hbm_total_bytes", "unit": "bytes"},
    # --- live profiling plane: scheduling-latency breakdown ---
    {"title": "Scheduling phase latency p50/p99",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_sched_phase_seconds_bucket[5m]))',
     "expr_b": 'histogram_quantile(0.99, '
               'rate(rtpu_sched_phase_seconds_bucket[5m]))',
     "legend": "{{phase}}", "unit": "s"},
    # --- memory & data-pipeline observability plane ---
    {"title": "Object store utilization (per node)",
     "expr": "rtpu_object_store_used_bytes",
     "expr_b": "rtpu_object_store_capacity_bytes",
     "legend": "{{node}}", "unit": "bytes"},
    {"title": "Spill / restore rate",
     "expr": "rate(rtpu_object_store_spills_total[5m])",
     "expr_b": "rate(rtpu_object_store_restores_total[5m])",
     "legend": "{{node}}", "unit": "short"},
    {"title": "Data pipeline rows/sec per stage",
     "expr": "rate(rtpu_data_rows_out_total[1m])",
     "legend": "{{stage}}", "unit": "short"},
    {"title": "Data backpressure: in-flight / queued per stage",
     "expr": "rtpu_data_inflight_tasks",
     "expr_b": "rtpu_data_queued_blocks",
     "legend": "{{stage}}", "unit": "short"},
    # --- paged KV cache & LLM router (serve/llm/kv_cache.py, router.py) ---
    {"title": "KV pool utilization",
     "expr": "rtpu_serve_kv_blocks_used / "
             "(rtpu_serve_kv_blocks_used + rtpu_serve_kv_blocks_free)",
     "unit": "percentunit"},
    {"title": "KV blocks used vs free",
     "expr": "rtpu_serve_kv_blocks_used",
     "expr_b": "rtpu_serve_kv_blocks_free", "unit": "short"},
    {"title": "Prefix-cache hit rate",
     "expr": "rate(rtpu_serve_prefix_cache_hits_total[5m]) / "
             "(rate(rtpu_serve_prefix_cache_hits_total[5m]) + "
             "rate(rtpu_serve_prefix_cache_misses_total[5m]))",
     "unit": "percentunit"},
    {"title": "Prefill tokens skipped via prefix cache",
     "expr": "rate(rtpu_serve_prefix_cache_hit_tokens_total[1m])",
     "unit": "short"},
    {"title": "Router queue depth per replica",
     "expr": "rtpu_serve_router_queue_depth",
     "legend": "{{replica}}", "unit": "short"},
    {"title": "Router requests per replica",
     "expr": "rate(rtpu_serve_router_requests_total[5m])",
     "legend": "{{replica}}", "unit": "short"},
    # --- disaggregated serving (serve/llm/disagg) ---
    {"title": "Lane queue depth",
     "expr": "rtpu_serve_lane_queue_depth",
     "legend": "{{lane}}", "unit": "short"},
    {"title": "Batch-decode preemptions",
     "expr": "rate(rtpu_serve_preemptions_total[5m])",
     "legend": "{{lane}}", "unit": "short"},
    {"title": "KV migration rate (blocks, bytes/sec)",
     "expr": "rate(rtpu_serve_kv_migrated_blocks_total[5m])",
     "expr_b": "rate(rtpu_serve_kv_migrated_bytes_total[5m])",
     "unit": "short"},
    {"title": "Speculative-decode accept ratio",
     "expr": "rtpu_serve_spec_accept_ratio",
     "unit": "percentunit"},
    {"title": "Router lane routing",
     "expr": "rate(rtpu_serve_router_lane_requests_total[5m])",
     "legend": "{{lane}}/{{pool}}", "unit": "short"},
    # --- KV memory hierarchy (kv_cache.KVTierManager + cache-aware router) ---
    {"title": "KV tier residency (hbm/host/store)",
     "expr": "rtpu_serve_kv_tier_bytes",
     "legend": "{{tier}}", "unit": "bytes"},
    {"title": "KV tier traffic: spills vs promotes",
     "expr": "rate(rtpu_serve_prefix_tier_spills_total[5m])",
     "expr_b": "rate(rtpu_serve_prefix_tier_promotes_total[5m])",
     "legend": "{{tier}}", "unit": "short"},
    # --- collectives (Pallas ICI backend + util.collective API) ---
    {"title": "Collective ops rate",
     "expr": "rate(rtpu_collective_ops_total[5m])",
     "legend": "{{op}}/{{backend}}", "unit": "short"},
    {"title": "Collective bytes/sec",
     "expr": "rate(rtpu_collective_bytes_total[5m])",
     "legend": "{{op}}/{{backend}}/{{dtype}}", "unit": "Bps"},
    {"title": "Collective op latency p50/p99",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_collective_op_seconds_bucket[5m]))',
     "expr_b": 'histogram_quantile(0.99, '
               'rate(rtpu_collective_op_seconds_bucket[5m]))',
     "legend": "{{op}}/{{backend}}", "unit": "s"},
    {"title": "Exposed comm fraction (split-phase overlap)",
     "expr": "rate(rtpu_collective_exposed_seconds_sum[5m]) / "
             "(rate(rtpu_collective_exposed_seconds_sum[5m]) + "
             "rate(rtpu_collective_hidden_seconds_sum[5m]))",
     "legend": "{{op}}/{{backend}}", "unit": "percentunit"},
    # --- request-scoped tracing (util/tracing.py + TraceStore) ---
    {"title": "Traces kept vs sampled out",
     "expr": "rate(rtpu_trace_kept_total[5m])",
     "expr_b": "rate(rtpu_trace_sampled_out_total[5m])",
     "unit": "short"},
    {"title": "Trace store pressure (pending, drops/sec)",
     "expr": "rtpu_trace_pending",
     "expr_b": "rate(rtpu_trace_spans_dropped_total[5m])",
     "unit": "short"},
    # --- metrics-driven control plane ---
    {"title": "Serve replicas (autoscaler)",
     "expr": "rtpu_serve_replicas",
     "legend": "{{deployment}}", "unit": "short"},
    {"title": "Control decisions rate",
     "expr": "rate(rtpu_ctrl_decisions_total[5m])",
     "legend": "{{controller}}/{{action}}", "unit": "short"},
    # --- decoupled RL (podracer plane) ---
    {"title": "RL acting vs learning throughput",
     "expr": "rate(rtpu_rl_env_steps_total[1m])",
     "expr_b": "rate(rtpu_rl_samples_total[1m])", "unit": "short"},
    {"title": "RL weight version / staleness",
     "expr": "rtpu_rl_weight_version",
     "expr_b": "rtpu_rl_weight_staleness", "unit": "short"},
    {"title": "RL sample queue depth / backpressure",
     "expr": "rtpu_rl_sample_queue_depth",
     "expr_b": "rate(rtpu_rl_backpressure_waits_total[5m])",
     "unit": "short"},
    {"title": "RL inference batching factor",
     "expr": "rate(rtpu_rl_infer_requests_total[5m]) / "
             "rate(rtpu_rl_infer_batches_total[5m])",
     "unit": "short"},
    # --- training goodput & stragglers (observability/goodput.py) ---
    {"title": "Train goodput ratio",
     "expr": "rtpu_train_goodput_ratio",
     "unit": "percentunit"},
    {"title": "Train step phase breakdown p50",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_train_step_phase_seconds_bucket[5m]))',
     "legend": "{{phase}}", "unit": "s"},
    {"title": "Train lost seconds by cause",
     "expr": "rate(rtpu_train_lost_seconds_total[5m])",
     "legend": "{{cause}}", "unit": "s"},
    {"title": "Train stragglers / stalls",
     "expr": 'rate(rtpu_cluster_events_total'
             '{type="TRAIN_STRAGGLER"}[5m])',
     "expr_b": 'rate(rtpu_cluster_events_total'
               '{type="TRAIN_STALL"}[5m])',
     "unit": "short"},
    # --- per-request cost accounting & SLO plane (observability/accounting) ---
    {"title": "Tenant chip-seconds/sec",
     "expr": "rate(rtpu_serve_tenant_chip_seconds_total[5m])",
     "legend": "{{tenant}}", "unit": "s"},
    {"title": "Tenant tokens/sec",
     "expr": "rate(rtpu_serve_tenant_tokens_total[1m])",
     "legend": "{{tenant}}", "unit": "short"},
    {"title": "Tenant KV block-seconds/sec",
     "expr": "rate(rtpu_serve_tenant_block_seconds_total[5m])",
     "legend": "{{tenant}}", "unit": "s"},
    {"title": "Request cost p50/p99 (chip-seconds)",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_serve_request_cost_chip_seconds_bucket[5m]))',
     "expr_b": 'histogram_quantile(0.99, '
               'rate(rtpu_serve_request_cost_chip_seconds_bucket[5m]))',
     "unit": "s"},
    {"title": "SLO attainment per lane",
     "expr": "rtpu_serve_slo_attainment_ratio",
     "legend": "{{lane}}", "unit": "percentunit"},
    {"title": "SLO burn rate (fast vs slow)",
     "expr": 'rtpu_serve_slo_burn_rate{window="fast"}',
     "expr_b": 'rtpu_serve_slo_burn_rate{window="slow"}',
     "legend": "{{lane}}/{{window}}", "unit": "short"},
    {"title": "SLO burn events",
     "expr": 'rate(rtpu_cluster_events_total{type="SLO_BURN"}[5m])',
     "unit": "short"},
    # --- XLA program cost & roofline attribution (observability/xla) ---
    {"title": "Program MFU / MBU",
     "expr": "rtpu_xla_program_mfu",
     "expr_b": "rtpu_xla_program_mbu",
     "legend": "{{fn}}", "unit": "percentunit"},
    {"title": "Program FLOPs / peak HBM bytes",
     "expr": "rtpu_xla_program_flops",
     "expr_b": "rtpu_xla_program_bytes_hbm",
     "legend": "{{fn}}", "unit": "short"},
    {"title": "Sampled program wall p50/p99",
     "expr": 'histogram_quantile(0.5, '
             'rate(rtpu_xla_program_wall_seconds_bucket[5m]))',
     "expr_b": 'histogram_quantile(0.99, '
               'rate(rtpu_xla_program_wall_seconds_bucket[5m]))',
     "legend": "{{fn}}", "unit": "s"},
    {"title": "Perf regression events",
     "expr": 'rate(rtpu_cluster_events_total'
             '{type="PERF_REGRESSION"}[5m])',
     "unit": "short"},
]


def _panel(spec: Dict[str, str], panel_id: int, x: int, y: int
           ) -> Dict[str, Any]:
    targets = [{"expr": spec["expr"], "refId": "A",
                "legendFormat": spec.get("legend", "")}]
    if "expr_b" in spec:
        targets.append({"expr": spec["expr_b"], "refId": "B",
                        "legendFormat": "total"})
    return {
        "id": panel_id, "title": spec["title"], "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "fieldConfig": {"defaults": {"unit": spec.get("unit", "short")},
                        "overrides": []},
        "targets": targets,
    }


def generate_default_dashboard(
        extra_metric_names: Optional[List[str]] = None) -> Dict[str, Any]:
    """The default cluster dashboard; `extra_metric_names` appends one
    panel per user-defined metric (ray_tpu_torch.util.metrics name, without
    the rtpu_ prefix)."""
    specs = list(_PANELS)
    for name in extra_metric_names or []:
        specs.append({"title": name, "expr": f"rtpu_{name}"})
    panels = [_panel(s, i + 1, (i % 2) * 12, (i // 2) * 8)
              for i, s in enumerate(specs)]
    return {
        "title": "ray_tpu cluster",
        "uid": "ray-tpu-default",
        "tags": ["ray_tpu", "generated"],
        "timezone": "browser",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus",
        }]},
        "panels": panels,
    }


def write_dashboard(path: str,
                    extra_metric_names: Optional[List[str]] = None) -> str:
    with open(path, "w") as f:
        json.dump(generate_default_dashboard(extra_metric_names), f,
                  indent=2)
    return path
