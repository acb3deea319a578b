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
from ray_tpu_torch.observability.control import (
    ControlMetrics, Hysteresis, record_decision,
)
from ray_tpu_torch.observability.serve import ServeMetrics, serve_metrics

__all__ = [
    "AccountingMetrics", "ControlMetrics", "Hysteresis", "RequestMeter",
    "SLOTracker", "ServeMetrics", "TenantLedger", "TokenReconciler",
    "accounting_enabled", "fold_finished", "record_decision",
    "serve_metrics", "slo_targets", "tenant_ledger",
]
