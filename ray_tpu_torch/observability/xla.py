"""Per-program cost & roofline attribution plane.

The reference reaches into XLA: on each new program it reads the
compiler's ``cost_analysis()`` (flops, bytes accessed, transcendentals)
and ``memory_analysis()``. Eager PyTorch compiles nothing, so the port
counts: :class:`~ray_tpu_torch.observability.jit.TrackedJit` runs the
first call of each argument signature under :func:`count_costs`, a
``TorchDispatchMode`` that sees every aten op the call runs and adds up

- **FLOPs**, by ``torch.utils.flop_counter``'s aten formulas (matmuls,
  convolutions, library attention; elementwise ops count none, as in
  that counter),
- **bytes**, each non-view aten op's input plus output bytes (in eager
  mode every op reads its inputs from device memory and writes its
  outputs back), and
- **transcendentals**, one per output element of exp, log, tanh,
  sigmoid, rsqrt and their kin;

and on the card the call's device memory: argument and output bytes from
the tensors, temp and peak bytes from ``reset_peak_memory_stats`` /
``max_memory_allocated`` (``None`` on the CPU, never a guess). The
capture runs on the calling thread during the real first call: an engine
function mutates engine state, so unlike the reference's background
compile of a shape skeleton it cannot be run a second time.

**The hand kernels are invisible to a dispatch mode** (they launch
through ``ctypes``), so each kernel wrapper reports its own count with
:func:`kernel_cost`, by the formulas of the kernel's bound. Its plain
version reports the same count and its own aten ops are not counted, so
a program counts the same on the CPU and on the card.

Each captured program becomes a row of the per-process
:class:`ProgramRegistry`, keyed by ``(fn, signature)``. Steady-state
walls are sampled every Nth call (``xla_wall_sample_every``; 0 keeps
``torch.cuda.synchronize`` off the hot path) and divided into the device
peaks (observability/chipspec.py) to derive:

- **MFU**: achieved FLOP/s over the device's peak FLOP/s,
- **MBU**: achieved bytes/s over the device's peak memory bandwidth,
- a **roofline verdict**: ``comm-bound`` when the exposed-collective
  fraction of the sampled wall (observability/collective.py) exceeds
  ``xla_comm_bound_fraction``, else ``compute-bound``/``memory-bound`` by
  whichever side of the roofline the program sits on, and
- **lost-to-roofline headroom**: sampled wall minus the roofline-ideal
  wall, the seconds a call could reclaim at 100% utilization.

Rows publish fire-and-forget into the bounded GCS ring
(``report_xla_programs``; ``util.state.xla_summary()`` and
``GET /api/programs`` roll the fleet up) and export as the
``rtpu_xla_program_{flops,bytes_hbm,mfu,mbu}`` gauges plus the
``rtpu_xla_program_wall_seconds`` histogram (trace exemplars). The names
are the reference's, so its dashboards and alerts find them; on the card
they measure the CUDA program.

The **regression sentinel**: the first program a function runs becomes
its baseline (flops, peak device bytes, sampled wall); any later program
or wall sample drifting past ``xla_regression_ratio`` emits ONE typed
``PERF_REGRESSION`` cluster event naming the program and the drifted
dimension, and re-arms only when the dimension returns within the ratio.

Rows of a program that ran on the card carry ``spec="h100"`` and
``measurement="gpu"``; on the CPU ``measurement="cpu"`` (nominal
chipspec peaks): the plumbing is identical, the ratios prove wiring,
not performance.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.observability import chipspec

_lock = threading.Lock()
_registry: Optional["ProgramRegistry"] = None
_metrics = None

# Sampled program walls: sub-millisecond ticks to multi-second steps.
_WALL_BOUNDARIES = (0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1, 0.5,
                    2.0, 10.0, 60.0)

_EWMA_ALPHA = 0.3


# ------------------------------------------------------------------ knobs

def attribution_enabled() -> bool:
    """The ``xla_attribution_instrumentation`` master switch."""
    try:
        from ray_tpu_torch._private.config import GlobalConfig

        return bool(GlobalConfig.xla_attribution_instrumentation)
    except Exception:
        return False


def wall_sample_every() -> int:
    """Sampling period of steady-state walls; 0 disables sampling (and
    with it every ``torch.cuda.synchronize`` the plane would issue)."""
    try:
        from ray_tpu_torch._private.config import GlobalConfig

        return max(int(GlobalConfig.xla_wall_sample_every), 0)
    except Exception:
        return 0


# ---------------------------------------------------------------- metrics

class XlaMetrics:
    def __init__(self):
        from ray_tpu_torch.util.metrics import Gauge, Histogram

        tag_keys = ("fn",)
        self.flops = Gauge(
            "xla_program_flops", tag_keys=tag_keys,
            description="Counted FLOPs of the newest program per tracked "
                        "function (aten formulas plus the hand kernels' "
                        "own counts).")
        self.bytes_hbm = Gauge(
            "xla_program_bytes_hbm", tag_keys=tag_keys,
            description="Peak device bytes (argument+output+temp) of the "
                        "newest program per tracked function, on the "
                        "card.")
        self.mfu = Gauge(
            "xla_program_mfu", tag_keys=tag_keys,
            description="Model FLOP utilization of the newest sampled "
                        "wall: achieved FLOP/s over the device's peak "
                        "(CPU rows use the nominal cpu spec: plumbing, "
                        "not performance).")
        self.mbu = Gauge(
            "xla_program_mbu", tag_keys=tag_keys,
            description="Memory-bandwidth utilization of the newest "
                        "sampled wall: achieved bytes/s over the "
                        "device's peak bandwidth.")
        self.wall_seconds = Histogram(
            "xla_program_wall_seconds", boundaries=_WALL_BOUNDARIES,
            tag_keys=tag_keys,
            description="Sampled steady-state execution wall of tracked "
                        "programs (every xla_wall_sample_every-th call, "
                        "fenced with torch.cuda.synchronize).")


def xla_metrics() -> XlaMetrics:
    global _metrics
    with _lock:
        if _metrics is None:
            _metrics = XlaMetrics()
        return _metrics


# ----------------------------------------------------------- cost counter

_tls = threading.local()

# Ops whose output elements each take one transcendental evaluation.
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos",
    "tan", "tanh", "sigmoid", "rsqrt", "sqrt", "erf", "erfinv", "silu",
    "gelu", "softmax", "_softmax", "log_softmax", "_log_softmax",
    "logsumexp"))
# Ops that move no bytes: views the schema does not mark as such, and
# allocations.
_NO_BYTES = frozenset((
    "_unsafe_view", "detach", "lift_fresh", "alias", "_reshape_alias",
    "as_strided", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense"))


def _tensors(tree) -> List[Any]:
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> float:
    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, np.ndarray):
            total += t.nbytes
    return float(total)


class _Program:
    """A tracked signature's artifact: the counts captured on its first
    call, in the shapes of the reference's ``Compiled`` accessors."""

    def __init__(self, cost: Dict[str, float], memory: Dict[str, Any],
                 device: str):
        self._cost = cost
        self._memory = memory
        self.device = device

    def cost_analysis(self) -> Dict[str, float]:
        return dict(self._cost)

    def memory_analysis(self) -> Dict[str, Any]:
        return dict(self._memory)


class CostCounter:
    """What one captured call counted: ``flops``, ``bytes accessed`` and
    ``transcendentals`` (the reference's cost-analysis keys), plus the
    devices its tensors lived on."""

    def __init__(self, args=(), kwargs=None):
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.devices = set()
        self._arg_bytes = _nbytes((args, kwargs or {}))
        self.devices.update(t.device.type for t in _tensors(
            (args, kwargs or {})))
        self._mem0 = None
        self._memory = None

    def add(self, flops: float, nbytes: float,
            transcendentals: float = 0.0) -> None:
        self.flops += float(flops)
        self.bytes += float(nbytes)
        self.transcendentals += float(transcendentals)

    def _cuda(self) -> bool:
        import torch

        return torch.cuda.is_initialized()

    def start_memory(self) -> None:
        import torch

        if self._cuda():
            torch.cuda.synchronize()
            self._mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def finish(self, out) -> None:
        """Close the call's books on its output: argument and output
        bytes from the tensors; temp and peak bytes from the caching
        allocator's peak on the card (None where no card was used)."""
        import torch

        self.devices.update(t.device.type for t in _tensors(out))
        out_bytes = _nbytes(out)
        temp = peak = None
        if self._mem0 is not None and "cuda" in self.devices:
            torch.cuda.synchronize()
            grew = torch.cuda.max_memory_allocated() - self._mem0
            temp = float(max(grew - out_bytes, 0))
            peak = self._arg_bytes + out_bytes + temp
        self._memory = {"arg_bytes": self._arg_bytes,
                        "out_bytes": out_bytes, "temp_bytes": temp,
                        "alias_bytes": 0.0, "peak_hbm_bytes": peak}

    def cost(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "transcendentals": self.transcendentals}

    def artifact(self) -> _Program:
        if self._memory is None:
            self.finish(None)
        return _Program(self.cost(), self._memory,
                        "cuda" if "cuda" in self.devices else "cpu")


def _counting_mode():
    """The TorchDispatchMode class (built on first use: importing this
    module must not import torch's dispatch machinery)."""
    global _Mode
    if _Mode is not None:
        return _Mode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _CostMode(TorchDispatchMode):
        @classmethod
        def _should_skip_dynamo(cls) -> bool:
            # The mode runs under eager programs only. Left on, torch
            # wraps the handler to disable compilation in it, which
            # imports torch._dynamo at the process's first capture
            # (seconds, on every fresh worker's first request).
            return False

        def __init__(self, counter: CostCounter):
            super().__init__()
            self.counter = counter

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if getattr(_tls, "suppress", 0):
                return out
            try:
                self._count(func, args, kwargs, out)
            except Exception:
                pass  # counting must never break the call
            return out

        def _count(self, func, args, kwargs, out):
            c = self.counter
            packet = func.overloadpacket
            name = packet.__name__
            formula = flop_registry.get(packet)
            if formula is not None:
                c.flops += float(formula(*args, **kwargs, out_val=out))
            outs = _tensors(out)
            for t in outs:
                c.devices.add(t.device.type)
            if name.rstrip("_") in _TRANSCENDENTAL:
                c.transcendentals += float(sum(t.numel() for t in outs))
            if func.is_view or name in _NO_BYTES:
                return
            c.bytes += _nbytes((args, kwargs)) + _nbytes(out)

    _Mode = _CostMode
    return _Mode


_Mode = None


class count_costs:
    """``with count_costs(args, kwargs) as counter: out = fn(*args,
    **kwargs); counter.finish(out)``: count what the call runs on this
    thread (see the module docstring) into ``counter``. Nested counters
    each count the whole inner call."""

    def __init__(self, args=(), kwargs=None):
        self.counter = CostCounter(args, kwargs)
        self._mode = None

    def __enter__(self) -> CostCounter:
        stack = getattr(_tls, "counters", None)
        if stack is None:
            stack = _tls.counters = []
        stack.append(self.counter)
        self.counter.start_memory()
        self._mode = _counting_mode()(self.counter)
        self._mode.__enter__()
        return self.counter

    def __exit__(self, *exc) -> None:
        try:
            self._mode.__exit__(*exc)
        finally:
            _tls.counters.remove(self.counter)


class kernel_cost:
    """``with kernel_cost(flops, nbytes, transcendentals): ...`` around a
    hand kernel's launch (or its plain version): report the kernel's own
    count to every active counter once, and count none of the aten ops
    inside (the plain version's math, the wrapper's padding and copies).
    A region inside another reports nothing: the outer region's count
    covers it."""

    __slots__ = ("cost",)

    def __init__(self, flops: float, nbytes: float,
                 transcendentals: float = 0.0):
        self.cost = (flops, nbytes, transcendentals)

    def __enter__(self):
        depth = getattr(_tls, "suppress", 0)
        if depth == 0:
            for counter in getattr(_tls, "counters", ()):
                counter.add(*self.cost)
        _tls.suppress = depth + 1
        return self

    def __exit__(self, *exc) -> None:
        _tls.suppress -= 1


def counts(cost_of):
    """Decorator: the wrapped kernel launcher (or plain version) counts
    as ``kernel_cost(*cost_of(*args, **kwargs))`` in a program's costs.
    The launch counter a wrapper keeps as an attribute of its own name
    lands on the decorated function, which is what that name holds."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with kernel_cost(*cost_of(*args, **kwargs)):
                return fn(*args, **kwargs)
        return wrapped
    return deco


# --------------------------------------------------------------- registry

def _cost_dict(compiled) -> Dict[str, float]:
    """Normalize ``compiled.cost_analysis()``: a dict, or a list of
    per-computation dicts (the shape some XLA backends give)."""
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return dict(cost or {})


def _memory_dict(compiled) -> Dict[str, Optional[float]]:
    """The row's memory fields from ``compiled.memory_analysis()``: a
    captured dict (this plane's artifacts) or an object with XLA's
    ``*_size_in_bytes`` attributes. Peak follows XLA's accounting:
    arguments + outputs + temps, minus bytes aliased between them; a
    temp of None (the CPU) leaves the peak None."""
    mem = compiled.memory_analysis()
    if isinstance(mem, dict):
        def get(key):
            v = mem.get(key)
            return None if v is None else float(v)

        arg, out = get("arg_bytes") or 0.0, get("out_bytes") or 0.0
        temp, alias = get("temp_bytes"), get("alias_bytes") or 0.0
    else:
        arg = float(getattr(mem, "argument_size_in_bytes", 0) or 0)
        out = float(getattr(mem, "output_size_in_bytes", 0) or 0)
        temp = float(getattr(mem, "temp_size_in_bytes", 0) or 0)
        alias = float(getattr(mem, "alias_size_in_bytes", 0) or 0)
    return {
        "arg_bytes": arg,
        "out_bytes": out,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "peak_hbm_bytes": (None if temp is None
                           else max(arg + out + temp - alias, 0.0)),
    }


class ProgramRegistry:
    """Per-process table of program cost rows, keyed by
    ``(fn, signature)``, plus the per-function regression sentinel."""

    # Sentinel dimensions and the row/baseline field each compares.
    _SENTINEL_DIMS = ("flops", "peak_hbm_bytes", "wall_s")

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # fn -> {"flops", "peak_hbm_bytes", "wall_s"} of its FIRST
        # program: the drift reference.
        self._baselines: Dict[str, Dict[str, Any]] = {}
        # fn -> set of dimensions currently in a fired episode.
        self._episodes: Dict[str, set] = {}

    # -- capture ----------------------------------------------------

    def record_compile(self, fn: str, signature: str, compiled,
                       compile_seconds: float,
                       calls: int = 0) -> Optional[Dict[str, Any]]:
        """Record one new program's counts (``compiled`` has the
        reference's ``cost_analysis()``/``memory_analysis()``). Returns
        the (published) row, or None when the artifact gives no counts."""
        try:
            cost = _cost_dict(compiled)
            mem = _memory_dict(compiled)
        except Exception:
            return None
        device = getattr(compiled, "device", None)
        spec = (chipspec.spec_for_device(device) if device is not None
                else chipspec.local_spec())
        row = {
            "fn": fn,
            "signature": signature,
            "flops": float(cost.get("flops", 0.0) or 0.0),
            "bytes_accessed": float(
                cost.get("bytes accessed", 0.0) or 0.0),
            "transcendentals": float(
                cost.get("transcendentals", 0.0) or 0.0),
            **mem,
            "compile_seconds": float(compile_seconds),
            "calls": int(calls),
            "samples": 0,
            "wall_s": None,
            "achieved_flops_per_s": None,
            "achieved_bytes_per_s": None,
            "mfu": None,
            "mbu": None,
            "exposed_comm_fraction": 0.0,
            "verdict": "unsampled",
            "lost_roofline_s_per_call": None,
            "lost_roofline_s_total": None,
            "spec": spec.spec,
            "measurement": spec.measurement,
            "pid": os.getpid(),
            "ts": time.time(),
        }
        with self._lock:
            fresh_program = (fn, signature) not in self._rows
            self._rows[(fn, signature)] = row
            baseline = self._baselines.get(fn)
            if baseline is None:
                # First program of this function: it IS the baseline.
                self._baselines[fn] = {
                    "flops": row["flops"],
                    "peak_hbm_bytes": row["peak_hbm_bytes"],
                    "wall_s": None,
                    "signature": signature,
                }
                baseline = None
        try:
            m = xla_metrics()
            tags = {"fn": fn}
            m.flops.set(row["flops"], tags=tags)
            if row["peak_hbm_bytes"] is not None:
                m.bytes_hbm.set(row["peak_hbm_bytes"], tags=tags)
        except Exception:
            pass
        if baseline is not None and fresh_program:
            # A new program of a function with a baseline: check the
            # static dimensions for drift right now, before any sample.
            self._check_drift(fn, row, baseline,
                              dims=("flops", "peak_hbm_bytes"))
        _publish_row(row)
        return row

    def record_sample(self, fn: str, signature: str, wall_s: float,
                      exposed_comm_s: float = 0.0,
                      calls: int = 0,
                      trace_id: Optional[str] = None
                      ) -> Optional[Dict[str, Any]]:
        """Fold one sampled steady-state wall into the program's row:
        EWMA wall, achieved rates, MFU/MBU, roofline verdict, headroom.
        No-op for programs the registry never captured."""
        wall_s = float(wall_s)
        if wall_s <= 0:
            return None
        with self._lock:
            row = self._rows.get((fn, signature))
            if row is None:
                return None
            prev = row["wall_s"]
            row["wall_s"] = (wall_s if prev is None else
                             _EWMA_ALPHA * wall_s
                             + (1 - _EWMA_ALPHA) * prev)
            row["samples"] += 1
            if calls:
                row["calls"] = int(calls)
            row["ts"] = time.time()
            self._derive_locked(row, exposed_comm_s / wall_s)
            baseline = self._baselines.get(fn)
            if baseline is not None and baseline["wall_s"] is None \
                    and baseline["signature"] == signature:
                baseline["wall_s"] = row["wall_s"]
            row = dict(row)
        try:
            m = xla_metrics()
            tags = {"fn": fn}
            m.wall_seconds.observe(wall_s, tags=tags, trace_id=trace_id)
            if row["mfu"] is not None:
                m.mfu.set(row["mfu"], tags=tags)
            if row["mbu"] is not None:
                m.mbu.set(row["mbu"], tags=tags)
        except Exception:
            pass
        if baseline is not None:
            self._check_drift(fn, row, baseline, dims=("wall_s",))
        _publish_row(row)
        return row

    def _derive_locked(self, row: Dict[str, Any],
                       exposed_fraction: float) -> None:
        """Recompute the derived columns of one row in place (holding
        the registry lock)."""
        wall = row["wall_s"]
        row["achieved_flops_per_s"] = row["flops"] / wall
        row["achieved_bytes_per_s"] = row["bytes_accessed"] / wall
        row["exposed_comm_fraction"] = min(max(exposed_fraction, 0.0),
                                           1.0)
        spec = chipspec.lookup(row["spec"])
        if not spec.known:
            row["mfu"] = None
            row["mbu"] = None
            row["lost_roofline_s_per_call"] = None
            row["lost_roofline_s_total"] = None
            row["verdict"] = "unknown"
            return
        row["mfu"] = row["achieved_flops_per_s"] / spec.peak_flops
        row["mbu"] = (row["achieved_bytes_per_s"]
                      / spec.peak_hbm_bytes_per_s)
        # Roofline-ideal wall: the slower of "all flops at peak" and
        # "all bytes at peak bandwidth". What the sampled wall spends
        # beyond that is reclaimable headroom.
        ideal = max(row["flops"] / spec.peak_flops,
                    row["bytes_accessed"] / spec.peak_hbm_bytes_per_s)
        lost = max(wall - ideal, 0.0)
        row["lost_roofline_s_per_call"] = lost
        row["lost_roofline_s_total"] = lost * max(row["calls"], 1)
        try:
            from ray_tpu_torch._private.config import GlobalConfig

            comm_threshold = float(GlobalConfig.xla_comm_bound_fraction)
        except Exception:
            comm_threshold = 0.5
        if row["exposed_comm_fraction"] > comm_threshold:
            row["verdict"] = "comm-bound"
        elif row["mfu"] >= row["mbu"]:
            row["verdict"] = "compute-bound"
        else:
            row["verdict"] = "memory-bound"

    # -- regression sentinel ----------------------------------------

    def _check_drift(self, fn: str, row: Dict[str, Any],
                     baseline: Dict[str, Any], dims) -> None:
        """Compare ``row`` against the function's baseline on ``dims``;
        fire PERF_REGRESSION once per drifted-dimension episode."""
        try:
            from ray_tpu_torch._private.config import GlobalConfig

            ratio_limit = float(GlobalConfig.xla_regression_ratio)
        except Exception:
            ratio_limit = 1.5
        if ratio_limit <= 0:
            return
        for dim in dims:
            base = baseline.get(dim)
            cur = row.get(dim)
            if not base or cur is None:
                continue
            ratio = float(cur) / float(base)
            with self._lock:
                episode = self._episodes.setdefault(fn, set())
                if ratio > ratio_limit:
                    if dim in episode:
                        continue  # already fired this episode
                    episode.add(dim)
                    fire = True
                else:
                    episode.discard(dim)  # back within: re-arm
                    fire = False
            if fire:
                _emit_regression(fn, row, dim, ratio, float(base),
                                 float(cur))

    # -- views ------------------------------------------------------

    def rows(self):
        with self._lock:
            return [dict(r) for r in self._rows.values()]

    def row(self, fn: str, signature: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            r = self._rows.get((fn, signature))
            return dict(r) if r else None

    def baseline(self, fn: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            b = self._baselines.get(fn)
            return dict(b) if b else None

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._baselines.clear()
            self._episodes.clear()


def program_registry() -> ProgramRegistry:
    """The per-process registry singleton."""
    global _registry
    with _lock:
        if _registry is None:
            _registry = ProgramRegistry()
        return _registry


# ---------------------------------------------------- TrackedJit bridge

def on_tracked_compile(tracked, seconds: float, args, kwargs,
                       artifact) -> None:
    """Hook ``TrackedJit`` calls on every new signature, with the counts
    its first call captured: record the program's row (on the calling
    thread; the counting already happened during the call)."""
    if not attribution_enabled():
        return
    program_registry().record_compile(
        tracked.name, tracked.signature(args, kwargs), artifact, seconds,
        calls=getattr(tracked, "calls", 0))


def flush_captures(timeout: float = 30.0) -> bool:
    """The reference's barrier on its background capture queue. Captures
    here happen during the first call itself, so nothing is ever pending:
    always True."""
    return True


def on_tracked_sample(tracked, signature: str, wall_s: float,
                      exposed_comm_s: float) -> None:
    """Sampled-wall hook: fold one fenced execution wall into the row,
    stamping the live trace (if any) as the metric exemplar."""
    trace_id = None
    try:
        from ray_tpu_torch.util.tracing import current_trace

        ctx = current_trace()
        if ctx is not None:
            trace_id = getattr(ctx, "trace_id", None)
    except Exception:
        pass
    program_registry().record_sample(
        tracked.name, signature, wall_s,
        exposed_comm_s=exposed_comm_s,
        calls=getattr(tracked, "calls", 0), trace_id=trace_id)


# ------------------------------------------------------------ publication

def _publish_row(row: Dict[str, Any]) -> bool:
    """Fire-and-forget report of one program row into the GCS ring
    (``report_xla_programs``). False (silently) outside a connected
    worker: a bare process still gets the local registry + metrics."""
    try:
        from ray_tpu_torch._private.worker import global_worker_or_none

        w = global_worker_or_none()
        if w is None or getattr(w, "_dead", False):
            return False
        payload = dict(row)
        payload.setdefault("node_id", w.node_id)
        w.gcs.cast("report_xla_programs", row=payload)
        return True
    except Exception:
        return False


def _emit_regression(fn: str, row: Dict[str, Any], dim: str,
                     ratio: float, base: float, cur: float) -> None:
    """One typed PERF_REGRESSION cluster event naming the program and
    the drifted dimension."""
    message = (f"program {fn!r} {row.get('signature', '')}: {dim} "
               f"drifted to {ratio:.2f}x its baseline "
               f"({base:.4g} -> {cur:.4g})")
    try:
        from ray_tpu_torch._private.worker import global_worker_or_none

        w = global_worker_or_none()
        if w is None or getattr(w, "_dead", False):
            return
        w.gcs.call(
            "report_cluster_event", event_type="PERF_REGRESSION",
            message=message,
            extra={"fn": fn, "signature": row.get("signature"),
                   "dimension": dim, "ratio": ratio,
                   "baseline": base, "current": cur,
                   "measurement": row.get("measurement")},
            timeout=5)
    except Exception:
        pass  # the sentinel must never take down the sampled call


def local_programs():
    """This process's registry rows (fleet view: util.state.xla_summary)."""
    return program_registry().rows()
