"""The port's observability, the copies of the reference's jax-free
pieces the serving engine reports through:

- ``serve``: the LLM engine's metric set (``serve_metrics()``): latency
  histograms, queue/slot/pool gauges, prefix, tier, migration,
  preemption and speculative counters.
- ``accounting``: per-request cost meters (``RequestMeter``), the
  bounded tenant ledger, SLO attainment and burn (``SLOTracker``), and
  the token reconciliation self-check (``TokenReconciler``).
- ``control``: the decision counter and span, and with a worker the GCS
  decision ring and cluster event (``record_decision``), and the
  ``Hysteresis`` gate the serve autoscaler and the preemption policy
  read.
- ``collective``: the ``util.collective`` API's op and byte counters,
  latency histogram and spans (``observe_collective``), and the
  split-phase exposed/hidden books (``record_overlap``,
  ``cumulative_exposed_seconds``).
- ``jit``: ``tracked_jit``, the reference's trace/compile accounting over
  eager callables (a trace is the first call of a new argument
  signature), ``jit_stats`` and ``RecompileWarning``.
- ``xla``: the program plane: each tracked signature's FLOPs, bytes and
  device memory counted on its first call (``ProgramRegistry``), MFU/MBU
  and the roofline verdict from sampled walls, the GCS program ring and
  the ``PERF_REGRESSION`` sentinel; ``chipspec`` holds the H100's peaks.
- ``device``: the ``device_hbm_used_bytes`` / ``device_hbm_total_bytes``
  / ``device_count`` gauges, sampled only where a CUDA context exists.
- ``profiling``: the device-trace bracket ``capture_tpu_trace`` over
  ``torch.profiler``, beside the host stack sampler.

The names are the reference's (``xla_*``, ``tpu_profile``), so its
callers, dashboards and alerts find them; on the card each measures the
CUDA program or device.

Metrics live in ``util.metrics``'s process-local registry, pushed to the
GCS by its flusher where the process has a worker attached; spans go to
the worker's task events (the GCS trace store) there, and to
``util.tracing``'s span buffer in a process without one.
"""

from ray_tpu_torch.observability.accounting import (
    AccountingMetrics, RequestMeter, SLOTracker, TenantLedger,
    TokenReconciler, accounting_enabled, fold_finished, slo_targets,
    tenant_ledger,
)
from ray_tpu_torch.observability.collective import (
    CollectiveMetrics, collective_metrics, cumulative_exposed_seconds,
    observe_collective, record_overlap,
)
from ray_tpu_torch.observability.control import (
    ControlMetrics, Hysteresis, record_decision,
)
from ray_tpu_torch.observability.chipspec import (
    ChipSpec, local_spec, lookup,
)
from ray_tpu_torch.observability.device import sample_device_metrics
from ray_tpu_torch.observability.jit import (
    RecompileWarning, TrackedJit, jit_stats, tracked_jit,
)
from ray_tpu_torch.observability.profiling import capture_tpu_trace
from ray_tpu_torch.observability.serve import ServeMetrics, serve_metrics
from ray_tpu_torch.observability.xla import (
    ProgramRegistry, attribution_enabled, flush_captures, local_programs,
    program_registry, wall_sample_every, xla_metrics,
)

__all__ = [
    "AccountingMetrics", "CollectiveMetrics", "ControlMetrics",
    "Hysteresis", "RequestMeter", "SLOTracker", "ServeMetrics", "TenantLedger", "TokenReconciler",
    "accounting_enabled", "collective_metrics",
    "cumulative_exposed_seconds", "fold_finished", "observe_collective",
    "record_decision", "record_overlap",
    "serve_metrics", "slo_targets", "tenant_ledger",
    "RecompileWarning", "TrackedJit", "tracked_jit", "jit_stats",
    "sample_device_metrics", "capture_tpu_trace",
    "ChipSpec", "local_spec", "lookup",
    "ProgramRegistry", "attribution_enabled", "flush_captures",
    "local_programs", "program_registry", "wall_sample_every",
    "xla_metrics",
]
