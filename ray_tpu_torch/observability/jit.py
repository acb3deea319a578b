"""Trace/compile accounting for tracked eager programs.

The reference jits its hot programs, and a hot path that feeds one
changing shapes or dtypes retraces (and recompiles) silently.
:class:`TrackedJit` keeps the reference's API and accounting over an
eager callable:

    tick = tracked_jit(tick_fn, name="engine_tick", trace_budget=1)
    out = tick(params, state)           # calls tick_fn(params, state)
    tick.traces                         # signatures seen by THIS wrapper

**What counts as a trace.** Eager PyTorch compiles nothing, so a
"trace" is the first call with a new argument signature, by the rule
under which JAX retraces:

- tensors and numpy arrays count by shape and dtype (a tensor also by
  its device type; a numpy array's 64-bit types as the 32-bit ones, as
  JAX canonicalizes them);
- pytrees (lists, tuples, dicts) count by their structure;
- Python ``int``/``float``/``bool`` are abstract (JAX's weak types): a
  new value is not a new trace, a new type is, unless the argument is
  named in ``static_argnums``/``static_argnames``, where it counts by
  value;
- other objects count by value.

Each new trace increments the ``jit_traces_total`` / ``jit_compiles_total``
counters (tagged by function name), observes the first call's wall time
(synchronized on the card at both ends) into the ``jit_compile_seconds``
histogram, books it as recompile time with the goodput ledger, records a
``jit_compile`` span, and hands the program's counts to the program plane
(observability/xla.py). When an instance traces past ``trace_budget`` it
warns ONCE with :class:`RecompileWarning` naming the function and the
argument signature that caused the trace.

The first call of each signature runs under the plane's cost counter
(FLOPs, bytes, transcendentals, device memory: ``xla.count_costs``), so
:meth:`TrackedJit.compiled` returns that signature's captured counts.
Every ``xla_wall_sample_every``-th steady-state call is fenced with
``torch.cuda.synchronize()`` to sample an honest execution wall (0
disables sampling: the fence never runs on the hot path).

Budgets are per instance (a fresh engine legitimately traces its own
programs); the counters aggregate per function name across instances and
processes. ``donate_argnums`` is accepted and ignored (eager PyTorch
frees a tensor when its last reference goes). ``lower`` has no
counterpart in eager PyTorch and raises.
"""

from __future__ import annotations

import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_lock = threading.Lock()
# name -> {"traces": int, "compiles": int, "compile_seconds_total": float}
_stats: Dict[str, Dict[str, float]] = {}

_metrics = None

# The keyword arguments of ``jax.jit`` a tracked callable takes: the two
# static ones shape the signature, the rest change nothing in eager mode.
_STATIC_KW = ("static_argnums", "static_argnames")
_IGNORED_KW = ("donate_argnums", "donate_argnames", "keep_unused",
               "inline", "device", "backend")


class RecompileWarning(UserWarning):
    """A tracked function traced beyond its trace budget."""


def _jit_metrics():
    """Lazy module-level metric singletons (one registry entry per
    process regardless of how many TrackedJit instances exist)."""
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.util.metrics import Counter, Histogram

        _metrics = {
            "traces": Counter(
                "jit_traces_total",
                description="Traces (new argument signatures) of tracked "
                            "functions.",
                tag_keys=("fn",)),
            "compiles": Counter(
                "jit_compiles_total",
                description="Compiles (first calls of a new signature) of "
                            "tracked functions.",
                tag_keys=("fn",)),
            "compile_seconds": Histogram(
                "jit_compile_seconds",
                description="First-call wall time of a new signature, "
                            "synchronized on the card at both ends.",
                boundaries=(0.01, 0.05, 0.25, 1.0, 5.0, 15.0, 60.0,
                            300.0),
                tag_keys=("fn",)),
        }
    return _metrics


# JAX (64-bit mode off) takes a numpy argument's 64-bit types as their
# 32-bit ones, so an int64 array retraces nothing an int32 one traced.
_CANONICAL = {np.dtype(a).str: np.dtype(b).str for a, b in (
    (np.int64, np.int32), (np.uint64, np.uint32), (np.float64, np.float32),
    (np.complex128, np.complex64))}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _leaf_key(a: Any, static: bool) -> Any:
    """The retrace key of one argument (JAX's rule, see the module
    docstring). Reads shapes and dtypes only, never tensor data."""
    if static:
        return ("static", a)
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(a, torch.Tensor):
        return ("T", tuple(a.shape), a.dtype, a.device.type)
    if isinstance(a, (np.ndarray, np.generic)):
        return ("A", a.shape, _CANONICAL.get(a.dtype.str, a.dtype.str))
    if isinstance(a, (bool, int, float, complex)):
        return ("py", type(a))
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return (type(a), tuple(_leaf_key(x, False) for x in a))
    if isinstance(a, dict):
        return ("dict", tuple(sorted(
            ((k, _leaf_key(v, False)) for k, v in a.items()),
            key=lambda kv: repr(kv[0]))))
    try:
        hash(a)
        return ("value", a)
    except TypeError:
        return ("value", type(a), repr(a))


def _arg_signature(args, kwargs, static_nums=(), static_names=()) -> str:
    """Compact human-readable shape/dtype signature: tensors and arrays
    as ``dtype[shape]``, containers by type, abstract scalars by type and
    static arguments and other values by value."""
    def one(a: Any, static: bool = False) -> str:
        if static:
            return f"{type(a).__name__}:{a!r}"[:40]
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            return f"{_dtype_name(dtype)}[{','.join(map(str, shape))}]"
        if isinstance(a, (dict, list, tuple)):
            return type(a).__name__
        if isinstance(a, (bool, int, float, complex)):
            return type(a).__name__
        return f"{type(a).__name__}:{a!r}"[:40]

    parts = [one(a, i in static_nums) for i, a in enumerate(args)]
    parts += [f"{k}={one(v, k in static_names)}" for k, v in kwargs.items()]
    return "(" + ", ".join(parts) + ")"


def _fence() -> None:
    """Wait for the card where this process holds a CUDA context (never
    creates one)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TrackedJit:
    """An eager callable with the reference's ``tracked_jit`` accounting:
    traces (new argument signatures), first-call walls, the recompile
    budget, the program plane's counts and sampled walls."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 trace_budget: Optional[int] = None, **jit_kwargs):
        unknown = set(jit_kwargs) - set(_STATIC_KW) - set(_IGNORED_KW)
        if unknown:
            raise TypeError(f"tracked_jit got unexpected keyword arguments "
                            f"{sorted(unknown)}")
        self.name = name or getattr(fn, "__name__", "jitted")
        self.traces = 0
        self.calls = 0
        if trace_budget is None:
            from ray_tpu_torch._private.config import GlobalConfig

            trace_budget = GlobalConfig.jit_recompile_warn_budget
        self.trace_budget = trace_budget
        self._warned = False
        self._fn = fn
        nums = jit_kwargs.get("static_argnums") or ()
        self._static_nums = frozenset((nums,) if isinstance(nums, int)
                                      else nums)
        names = jit_kwargs.get("static_argnames") or ()
        self._static_names = frozenset((names,) if isinstance(names, str)
                                       else names)
        # Signature key -> the artifact of that signature's first call
        # (its captured counts), shared by the plane and compiled().
        self._programs: Dict[Any, Any] = {}
        from ray_tpu_torch.observability import xla as _xla

        self._attribute = _xla.attribution_enabled()
        self._sample_every = (_xla.wall_sample_every() if self._attribute
                              else 0)

    def _key(self, args, kwargs) -> Tuple:
        return (tuple(_leaf_key(a, i in self._static_nums)
                      for i, a in enumerate(args)),
                tuple(sorted((k, _leaf_key(v, k in self._static_names))
                             for k, v in kwargs.items())))

    def signature(self, args, kwargs) -> str:
        """The readable signature of a call (the program row's key)."""
        return _arg_signature(args, kwargs, self._static_nums,
                              self._static_names)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        key = self._key(args, kwargs)
        artifact = self._programs.get(key)
        if artifact is None:
            return self._first_call(key, args, kwargs)
        if self._sample_every > 0 and self.calls % self._sample_every == 0:
            return self._sampled_call(args, kwargs)
        return self._fn(*args, **kwargs)

    def _first_call(self, key, args, kwargs):
        from ray_tpu_torch.observability import xla as _xla

        self.traces += 1
        with _lock:
            st = _stats.setdefault(self.name, {
                "traces": 0, "compiles": 0, "compile_seconds_total": 0.0})
            st["traces"] += 1
        _fence()
        t0 = time.perf_counter()
        if self._attribute:
            with _xla.count_costs(args, kwargs) as counter:
                out = self._fn(*args, **kwargs)
                counter.finish(out)
            artifact = counter.artifact()
        else:
            out = self._fn(*args, **kwargs)
            artifact = None
        _fence()
        seconds = time.perf_counter() - t0
        self._programs[key] = artifact if artifact is not None else False
        self._on_compile(seconds, args, kwargs, artifact)
        return out

    def _sampled_call(self, args, kwargs):
        """Fence the call at both ends and hand its wall (plus the exposed
        collective seconds it straddled) to the program plane."""
        _fence()
        exposed0 = _cumulative_exposed()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        try:
            _fence()
            wall = time.perf_counter() - t0
            exposed = max(_cumulative_exposed() - exposed0, 0.0)
            from ray_tpu_torch.observability import xla as _xla

            _xla.on_tracked_sample(self, self.signature(args, kwargs),
                                   wall, exposed)
        except Exception:
            pass  # sampling must never break the hot path
        return out

    def _on_compile(self, seconds: float, args, kwargs, artifact) -> None:
        with _lock:
            st = _stats[self.name]
            st["compiles"] += 1
            st["compile_seconds_total"] += seconds
        try:
            m = _jit_metrics()
            tags = {"fn": self.name}
            m["compiles"].inc(1.0, tags=tags)
            m["traces"].inc(1.0, tags=tags)
            m["compile_seconds"].observe(seconds, tags=tags)
        except Exception:
            pass  # telemetry must never break the hot path
        try:
            # First-call wall time is lost training time: the goodput
            # ledger books it as "recompiling" when a train loop is live
            # in this process (no-op otherwise).
            from ray_tpu_torch.observability.goodput import record_recompile

            record_recompile(seconds)
        except Exception:
            pass
        try:
            from ray_tpu_torch.util.tracing import record_span

            record_span("jit_compile", time.time() - seconds, seconds,
                        attrs={"fn": self.name, "traces": self.traces})
        except Exception:
            pass
        if artifact is not None:
            try:
                from ray_tpu_torch.observability import xla as _xla

                _xla.on_tracked_compile(self, seconds, args, kwargs,
                                        artifact)
            except Exception:
                pass
        if (self.trace_budget and self.traces > self.trace_budget
                and not self._warned):
            self._warned = True
            warnings.warn(
                f"tracked function {self.name!r} traced {self.traces} "
                f"programs (budget {self.trace_budget}); last re-trace "
                f"caused by call {self.signature(args, kwargs)} — "
                f"check for varying shapes/dtypes/static args on the "
                f"hot path", RecompileWarning, stacklevel=4)

    # -- the reference's AOT surface ----------------------------------

    def compiled(self, *args, **kwargs):
        """The artifact of this call signature: its ``cost_analysis()``
        and ``memory_analysis()`` return the counts captured on the
        signature's first call. None for a signature never called (eager
        PyTorch cannot build a program ahead of its call) or called with
        attribution off. Never counts a trace."""
        artifact = self._programs.get(self._key(args, kwargs))
        return artifact or None

    def lower(self, *args, **kwargs):
        raise NotImplementedError(
            f"TrackedJit.lower ({self.name!r}): eager PyTorch lowers no "
            f"program; compiled() gives a called signature's counts")

    def eval_shape(self, *args, **kwargs):
        """Shape evaluation of the RAW function on fake tensors: returns
        the output pytree with each tensor as an empty ``meta`` tensor of
        its shape and dtype. Runs nothing on a device and counts nothing,
        so speculative shape queries cannot inflate the trace counters or
        mark a program as seen."""
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils._pytree import tree_map

        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            def fake(a):
                return (mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a)

            out = self._fn(*tree_map(fake, args), **tree_map(fake, kwargs))
        return tree_map(
            lambda t: (torch.empty(t.shape, dtype=t.dtype, device="meta")
                       if isinstance(t, torch.Tensor) else t), out)

    def clear_cache(self) -> None:
        """Forget every signature and its artifact: the next call
        re-traces (and re-counts) like a fresh wrapper's."""
        self._programs.clear()

    clear_caches = clear_cache


def _cumulative_exposed() -> float:
    """Total exposed split-phase collective seconds this process has
    booked so far (observability/collective.py); 0.0 when the plane is
    unused. Deltas around a sampled call feed the comm-bound verdict."""
    try:
        from ray_tpu_torch.observability.collective import (
            cumulative_exposed_seconds,
        )

        return cumulative_exposed_seconds()
    except Exception:
        return 0.0


def tracked_jit(fn: Optional[Callable] = None, *,
                name: Optional[str] = None,
                trace_budget: Optional[int] = None,
                **jit_kwargs):
    """The reference's ``tracked_jit`` over an eager callable.

    Usable directly (``tracked_jit(fn, static_argnums=...)``) or as a
    decorator (``@tracked_jit(name="step")``).
    """
    if fn is None:
        def deco(f):
            return TrackedJit(f, name=name, trace_budget=trace_budget,
                              **jit_kwargs)
        return deco
    return TrackedJit(fn, name=name, trace_budget=trace_budget,
                      **jit_kwargs)


def jit_stats() -> Dict[str, Dict[str, float]]:
    """Per-function aggregate {traces, compiles, compile_seconds_total}
    for every tracked function in this process."""
    with _lock:
        return {k: dict(v) for k, v in _stats.items()}
