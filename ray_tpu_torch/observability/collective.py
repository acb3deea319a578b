"""Collective-op instrumentation: the port's copy of
``ray_tpu/observability/collective.py``.

One singleton feeding the shared metric registry: every op that goes
through the ``ray_tpu_torch.util.collective`` API records

- ``rtpu_collective_ops_total{op,backend,dtype}``: op count,
- ``rtpu_collective_bytes_total{op,backend,dtype}``: payload bytes (the
  *input* tensor's bytes: what the interconnect carries scales with this
  times the ring's ``2(n-1)/n`` factor),
- ``rtpu_collective_op_seconds{op,backend}``: wall-time histogram,
- ``rtpu_collective_exposed_seconds{op,backend}`` /
  ``rtpu_collective_hidden_seconds{op,backend}``: for split-phase
  (start/wait) collectives, how much of the issued-to-awaited span was NOT
  covered by compute (exposed) vs covered (hidden), and
- a ``collective:<op>`` span per call (split-phase calls carry an
  ``overlapped`` attribute).

The names, tags and boundaries are the reference's. A tensor's dtype tag
is its torch dtype without the ``torch.`` prefix (``float32``,
``bfloat16``), numpy's name where numpy has one; its bytes are read from
the tensor, so a CUDA tensor is never copied to be metered.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_collective = None
_lock = threading.Lock()
# Process-lifetime total of exposed split-phase seconds.
_exposed_total = 0.0

# Collective latencies straddle microseconds (a small allreduce) to
# seconds (a large gather on a cold link).
_OP_BOUNDARIES = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                  1.0, 5.0, 30.0)


class CollectiveMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Counter, Histogram

        tag_keys = ("op", "backend", "dtype")
        self.ops = Counter(
            "collective_ops_total", tag_keys=tag_keys,
            description="Collective ops executed via the "
                        "util.collective API.")
        self.bytes = Counter(
            "collective_bytes_total", tag_keys=tag_keys,
            description="Input payload bytes handed to collective ops "
                        "(wire bytes ≈ this × 2(n-1)/n for ring "
                        "allreduce, ×1/4 under int8 quantization).")
        self.op_seconds = Histogram(
            "collective_op_seconds", boundaries=_OP_BOUNDARIES,
            tag_keys=("op", "backend"),
            description="Wall time of one collective op, host round-trip "
                        "included.")
        self.exposed_seconds = Histogram(
            "collective_exposed_seconds", boundaries=_OP_BOUNDARIES,
            tag_keys=("op", "backend"),
            description="Split-phase collective wall time NOT covered by "
                        "overlapped compute (the part the step actually "
                        "waits on).")
        self.hidden_seconds = Histogram(
            "collective_hidden_seconds", boundaries=_OP_BOUNDARIES,
            tag_keys=("op", "backend"),
            description="Split-phase collective wall time hidden under "
                        "compute between start_* and wait_*.")


def collective_metrics() -> CollectiveMetrics:
    global _collective
    with _lock:
        if _collective is None:
            _collective = CollectiveMetrics()
        return _collective


def _tensor_stats(tensor):
    """(dtype name, bytes) of a tensor or an array, without a copy."""
    if tensor is None:
        return "unknown", 0
    dtype = getattr(tensor, "dtype", None)
    nbytes = getattr(tensor, "nbytes", None)
    if dtype is not None and nbytes is not None:
        return str(dtype).replace("torch.", ""), int(nbytes)
    try:
        import numpy as np

        arr = np.asarray(tensor)
        return str(arr.dtype), int(arr.nbytes)
    except Exception:
        return "unknown", 0


@contextmanager
def observe_collective(op: str, backend: str, tensor=None,
                       overlapped=None):
    """Time one collective op: counters + latency histogram + a
    ``collective:<op>`` span. Pass ``overlapped=True|False`` for
    split-phase calls so the span records whether the op ran under
    compute."""
    from ray_tpu_torch.util.tracing import record_span

    dtype, nbytes = _tensor_stats(tensor)
    m = collective_metrics()
    start = time.time()
    try:
        yield
    finally:
        dur = time.time() - start
        tags = {"op": op, "backend": backend, "dtype": dtype}
        m.ops.inc(1, tags)
        if nbytes:
            m.bytes.inc(nbytes, tags)
        m.op_seconds.observe(dur, {"op": op, "backend": backend})
        try:
            attrs = {"backend": backend, "dtype": dtype, "bytes": nbytes}
            if overlapped is not None:
                attrs["overlapped"] = bool(overlapped)
            record_span(f"collective:{op}", start, dur, attrs)
        except Exception:
            pass


def record_overlap(op: str, backend: str, issued_to_awaited_s: float,
                   compute_covered_s: float) -> dict:
    """Book a split-phase collective's wall time into the exposed/hidden
    histograms: ``exposed = max(0, span - covered)``. Returns
    ``{"exposed_s", "hidden_s", "exposed_fraction"}``."""
    global _exposed_total
    span = max(float(issued_to_awaited_s), 0.0)
    covered = max(float(compute_covered_s), 0.0)
    exposed = max(0.0, span - covered)
    hidden = span - exposed
    with _lock:
        _exposed_total += exposed
    m = collective_metrics()
    tags = {"op": op, "backend": backend}
    m.exposed_seconds.observe(exposed, tags)
    m.hidden_seconds.observe(hidden, tags)
    try:
        # The live train step (if any) carves exposed time out of its
        # compute phase.
        from ray_tpu_torch.observability.goodput import \
            note_exposed_collective

        note_exposed_collective(exposed)
    except Exception:
        pass
    return {
        "exposed_s": exposed,
        "hidden_s": hidden,
        "exposed_fraction": exposed / span if span > 0 else 0.0,
    }


def cumulative_exposed_seconds() -> float:
    """Process-lifetime exposed split-phase collective seconds."""
    with _lock:
        return _exposed_total
