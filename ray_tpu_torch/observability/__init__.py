"""The port's observability, the copies of the reference's jax-free
pieces the serving engine reports through:

- ``serve``: the LLM engine's metric set (``serve_metrics()``): latency
  histograms, queue/slot/pool gauges, prefix, tier, migration,
  preemption and speculative counters.
- ``accounting``: per-request cost meters (``RequestMeter``), the
  bounded tenant ledger, SLO attainment and burn (``SLOTracker``), and
  the token reconciliation self-check (``TokenReconciler``).
- ``control``: the decision counter and span (``record_decision``) and
  the ``Hysteresis`` gate the preemption policy reads.

Metrics live in ``util.metrics``'s process-local registry and spans in
``util.tracing``'s span buffer until the port's runtime ships them.
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
