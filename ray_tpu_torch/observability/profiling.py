"""Live profiling plane: wall-clock stack sampling + scheduling phases.

Reference: `dashboard/modules/reporter/profile_manager.py` (py-spy /
memray driven dump+profile endpoints) and `ray stack` — here implemented
in-process over ``sys._current_frames()`` so no external tool is needed
on the worker image. Three layers share this module:

- :class:`StackSampler` — a daemon-thread wall-clock sampler at a
  configurable Hz with bounded memory (at most
  ``profiler_max_unique_stacks`` distinct ``(thread, stack)`` keys are
  retained; overflow is counted in ``dropped``, never allocated) and
  per-thread attribution. Results render as collapsed-stack text
  (:func:`collapse`, flamegraph.pl input) or speedscope JSON
  (:func:`render_speedscope`, https://speedscope.app — one sampled
  profile per thread).
- one-shot stack dumps (:func:`capture_thread_stacks` /
  :func:`format_thread_stacks`) — the ``ray stack`` equivalent used by
  the worker's ``dump_stacks`` RPC and the SIGUSR2 wedge dump.
- the scheduling-latency breakdown schema: :data:`SCHED_PHASES` is the
  per-task lifecycle (PENDING → LEASE_GRANTED → WORKER_STARTED →
  ARGS_READY → RUNNING) threaded through the lease protocol and the
  task-event ring; :func:`observe_sched_phases` folds consecutive
  phase timestamps into the ``rtpu_sched_phase_seconds{phase}``
  histogram so "is it the scheduler or the user code" is a one-glance
  Grafana question (Ray, arXiv:1712.05889 §4 chases exactly these
  millisecond-scale scheduling overheads; Podracer, arXiv:2104.06272,
  shows host-side stalls are the dominant TPU perf bug).

A fourth, the device-trace bracket (:func:`capture_tpu_trace`, the
reference's name), holds ``torch.profiler`` open over a live worker for
a window and writes a Chrome trace of its CUDA kernels and host ops.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Scheduling-phase schema (owner + worker sides of the lease protocol
# record these; timeline.py renders them as segmented submit arrows).
# ---------------------------------------------------------------------------

#: Per-task lifecycle phases in order. PENDING and LEASE_GRANTED are
#: stamped by the owner (submit / lease-batch pairing); WORKER_STARTED,
#: ARGS_READY and RUNNING are stamped on the executing worker and ride
#: back in the task reply (so one clock per segment endpoint pair —
#: owner-owner and worker-worker deltas never mix hosts' clocks; the
#: LEASE_GRANTED→WORKER_STARTED segment is the only cross-host one).
SCHED_PHASES = ("PENDING", "LEASE_GRANTED", "WORKER_STARTED",
                "ARGS_READY", "RUNNING")

#: Segment label keyed by the phase that *ends* it — the histogram
#: ``phase`` tag and the timeline segment name.
SCHED_SEGMENT_LABELS = {
    "LEASE_GRANTED": "lease_grant",    # submit -> a worker lease paired
    "WORKER_STARTED": "worker_start",  # push RPC -> worker picks it up
    "ARGS_READY": "args_fetch",        # function load + arg resolution
    "RUNNING": "exec_start",           # args ready -> user code entered
}

_sched_metrics = None
_sched_lock = threading.Lock()


def sched_metrics():
    """The ``rtpu_sched_phase_seconds{phase}`` histogram (lazy: importing
    this module must stay cheap enough for the RPC layer)."""
    global _sched_metrics
    with _sched_lock:
        if _sched_metrics is None:
            from ray_tpu_torch.util.metrics import Histogram

            _sched_metrics = Histogram(
                "sched_phase_seconds",
                description="Scheduling-latency breakdown per task: "
                            "seconds spent in each submit->execution "
                            "phase (lease_grant, worker_start, "
                            "args_fetch, exec_start).",
                tag_keys=("phase",),
                boundaries=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                            0.05, 0.1, 0.25, 0.5, 1.0, 2.5))
        return _sched_metrics


def observe_sched_phases(ts_by_phase: Dict[str, float]) -> None:
    """Fold one task's phase timestamps into the phase histogram.
    Deltas are taken between *consecutive present* phases (a missing
    middle phase widens the next segment rather than dropping it) and
    clamped at zero — the LEASE_GRANTED→WORKER_STARTED hop crosses
    hosts, so clock skew must not produce negative observations."""
    present = [(p, ts_by_phase[p]) for p in SCHED_PHASES
               if p in ts_by_phase]
    if len(present) < 2:
        return
    h = sched_metrics()
    for (_, ta), (pb, tb) in zip(present, present[1:]):
        h.observe(max(tb - ta, 0.0),
                  tags={"phase": SCHED_SEGMENT_LABELS.get(pb, pb)})


# ---------------------------------------------------------------------------
# One-shot stack dumps (the `ray stack` path)
# ---------------------------------------------------------------------------

def capture_thread_stacks() -> List[Dict[str, Any]]:
    """All-thread Python stacks, structured. Lock-free and best-effort:
    safe to call from a wedged process."""
    frames = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    out: List[Dict[str, Any]] = []
    for ident, frame in frames.items():
        t = threads.get(ident)
        out.append({
            "thread_name": t.name if t else f"thread-{ident}",
            "ident": ident,
            "daemon": bool(t.daemon) if t else None,
            "stack": "".join(traceback.format_stack(frame)),
        })
    out.sort(key=lambda r: r["thread_name"])
    return out


def format_thread_stacks(
        threads: Optional[List[Dict[str, Any]]] = None) -> str:
    """Render :func:`capture_thread_stacks` as one text blob (the shape
    the dashboard's stack endpoints and the SIGUSR2 dump print)."""
    rows = capture_thread_stacks() if threads is None else threads
    return "\n".join(
        f"--- thread {r['thread_name']}"
        f"{' (daemon)' if r.get('daemon') else ''} ---\n{r['stack']}"
        for r in rows)


# ---------------------------------------------------------------------------
# Wall-clock stack sampler
# ---------------------------------------------------------------------------

def _fold_frame_stack(frame, max_frames: int) -> str:
    """Collapse one frame chain into ``file:func:line;...`` root-first
    (flamegraph folded-stack order)."""
    stack: List[str] = []
    f = frame
    while f is not None and len(stack) < max_frames:
        code = f.f_code
        stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                     f"{code.co_name}:{f.f_lineno}")
        f = f.f_back
    return ";".join(reversed(stack))


class StackSampler:
    """Wall-clock sampling profiler over ``sys._current_frames()``.

    A daemon thread wakes ``hz`` times per second and folds every
    thread's current stack into a per-thread count table
    ``{thread_name: {folded_stack: n}}``. Wall-clock (not CPU): a thread
    parked in ``select()`` or a lock shows up at its park site — on TPU
    hosts that is the point, since the bug class is "the chips are idle
    because the host is blocked *here*" (Podracer §3).

    Memory is bounded: at most ``max_unique_stacks`` distinct
    ``(thread, stack)`` keys are kept; samples whose key would exceed
    the bound are counted in ``dropped`` instead of allocated, so a
    pathological workload (e.g. deep recursion with varying line
    numbers) cannot OOM the sampled process.
    """

    def __init__(self, hz: Optional[float] = None,
                 max_unique_stacks: Optional[int] = None,
                 max_frames: int = 128):
        from ray_tpu_torch._private.config import GlobalConfig

        self.hz = float(hz) if hz else float(GlobalConfig.profiler_default_hz)
        self.hz = min(max(self.hz, 1.0), 1000.0)
        self.max_unique_stacks = int(
            max_unique_stacks if max_unique_stacks is not None
            else GlobalConfig.profiler_max_unique_stacks)
        self.max_frames = max_frames
        self._counts: Dict[str, Dict[str, int]] = {}
        self._unique = 0
        self._samples = 0
        self._dropped = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._t1 = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StackSampler":
        if self._thread is not None:
            raise RuntimeError("StackSampler already started")
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="rtpu-stack-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._t1 = time.monotonic()
        return self.snapshot()

    def snapshot(self) -> Dict[str, Any]:
        """Current aggregate (valid while running — partial profiles of
        a dying worker are exactly this snapshot)."""
        with self._lock:
            counts = {t: dict(s) for t, s in self._counts.items()}
            samples, dropped = self._samples, self._dropped
        end = self._t1 or time.monotonic()
        return {"counts": counts, "samples": samples, "dropped": dropped,
                "duration_s": max(end - self._t0, 0.0), "hz": self.hz}

    # -- sampling loop -----------------------------------------------------
    def _run(self) -> None:
        period = 1.0 / self.hz
        own = threading.get_ident()
        next_tick = time.monotonic()
        while not self._stop.is_set():
            names = {t.ident: t.name for t in threading.enumerate()}
            try:
                frames = sys._current_frames()
            except Exception:
                frames = {}
            with self._lock:
                for ident, frame in frames.items():
                    if ident == own:
                        continue  # never sample the sampler itself
                    thread = names.get(ident, f"thread-{ident}")
                    folded = _fold_frame_stack(frame, self.max_frames)
                    per = self._counts.setdefault(thread, {})
                    if folded in per:
                        per[folded] += 1
                    elif self._unique < self.max_unique_stacks:
                        per[folded] = 1
                        self._unique += 1
                    else:
                        self._dropped += 1
                        continue
                    self._samples += 1
            next_tick += period
            delay = next_tick - time.monotonic()
            if delay <= 0:
                # overran (huge thread count / GIL contention): resync
                # rather than burning CPU trying to catch up.
                next_tick = time.monotonic()
                continue
            self._stop.wait(delay)


# ---------------------------------------------------------------------------
# Aggregation / rendering
# ---------------------------------------------------------------------------

def merge_counts(into: Dict[str, Dict[str, int]],
                 add: Dict[str, Dict[str, int]],
                 thread_prefix: str = "") -> Dict[str, Dict[str, int]]:
    """Fold one sampler's per-thread counts into an accumulator (used by
    the chunked ``util.state.profile`` client and the dashboard's
    cluster-wide speedscope merge; ``thread_prefix`` namespaces threads
    from different workers)."""
    for thread, stacks in (add or {}).items():
        per = into.setdefault(thread_prefix + thread, {})
        for folded, n in stacks.items():
            per[folded] = per.get(folded, 0) + n
    return into


def collapse(counts: Dict[str, Dict[str, int]]) -> str:
    """Collapsed-stack text (``thread;frame;...;frame count`` lines,
    flamegraph.pl / speedscope importable), hottest first."""
    lines = [(n, f"{thread};{folded} {n}")
             for thread, stacks in counts.items()
             for folded, n in stacks.items()]
    return "\n".join(line for _, line in
                     sorted(lines, key=lambda kv: (-kv[0], kv[1])))


def render_speedscope(counts: Dict[str, Dict[str, int]],
                      name: str = "ray_tpu_torch profile") -> Dict[str, Any]:
    """Speedscope file-format JSON (one ``sampled`` profile per thread,
    shared frame table). Save it and drop it on https://speedscope.app,
    or ``speedscope profile.json`` with the npm CLI."""
    frames: List[Dict[str, str]] = []
    frame_index: Dict[str, int] = {}
    profiles: List[Dict[str, Any]] = []
    for thread in sorted(counts):
        samples: List[List[int]] = []
        weights: List[int] = []
        for folded, n in sorted(counts[thread].items()):
            idxs = []
            for fr in folded.split(";"):
                i = frame_index.get(fr)
                if i is None:
                    i = frame_index[fr] = len(frames)
                    frames.append({"name": fr})
                idxs.append(i)
            samples.append(idxs)
            weights.append(n)
        profiles.append({
            "type": "sampled", "name": thread, "unit": "none",
            "startValue": 0, "endValue": sum(weights),
            "samples": samples, "weights": weights,
        })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name, "exporter": "ray_tpu_torch.observability.profiling",
        "shared": {"frames": frames},
        "profiles": profiles,
    }


# ---------------------------------------------------------------------------
# Device-trace capture (torch.profiler bracket; host flamegraphs and device
# traces come from the same util.state API)
# ---------------------------------------------------------------------------

# Kineto runs one profiler per process: a second bracket is refused.
_trace_lock = threading.Lock()
_primed = False
# Set while a bracket's recording window is open (after its priming).
window_open = threading.Event()
# How long a process's first bracket may wait for CUPTI to record, and
# the kernels each of its probe sessions launches (a window loses some of
# its first device records).
_PRIME_TIMEOUT_S = 60.0
_PRIME_LAUNCHES = 256


def _prime_cupti(profile, activities, kw) -> bool:
    """Open short probe sessions, each launching ``_PRIME_LAUNCHES`` tiny
    kernels, until one records a kernel (or ``_PRIME_TIMEOUT_S`` passes).
    On the H100 machine a process's first window sometimes recorded no
    kernel at all while CUPTI started, for seconds, and every window after
    a recording one did record."""
    import torch
    from torch.autograd import DeviceType

    dev = torch.cuda.current_device()
    deadline = time.monotonic() + _PRIME_TIMEOUT_S
    while True:
        with profile(activities=activities, **kw) as prof:
            for _ in range(_PRIME_LAUNCHES):
                torch.zeros(1, device=dev)
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return True
        if time.monotonic() > deadline:
            return False


def capture_tpu_trace(duration_s: float,
                      trace_dir: Optional[str] = None) -> Dict[str, Any]:
    """Hold ``torch.profiler`` (CPU and CUDA activities) open for
    ``duration_s`` and write its Chrome trace JSON under ``trace_dir``
    (default: ``tpu_profile_dir``, else the temp dir); returns
    ``{"artifact": path, "duration_s", "kernel_events", "primed_s"}``:
    the number of CUDA kernel records in the trace, and the seconds this
    call waited for CUPTI first (``_prime_cupti``; 0 after a process's
    first bracket). The name is the reference's; on the card it traces
    the CUDA device.

    CUPTI records the kernels of every thread of the process, but the CPU
    ops only of the thread that opened the profiler (this one): read a
    trace's device side by its kernel events.

    A process without a CUDA context gets ``{"skipped": reason}``: the
    bracket never creates a context, and never gives a CPU-only trace in
    a process that holds the card. A second bracket while one is open in
    this process raises ``RuntimeError`` (Kineto takes one profiler per
    process). Blocking: callers run it in an executor thread."""
    global _primed
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {"skipped": "this process holds no CUDA context: no device "
                           "trace taken (host-side profile() still works)"}
    if not _trace_lock.acquire(blocking=False):
        raise RuntimeError("a device trace is already open in this process "
                           "(torch.profiler takes one at a time)")
    try:
        import inspect

        from torch.profiler import ProfilerActivity, profile

        # One window, every event kept (the default clears each cycle's).
        kw = ({"acc_events": True}
              if "acc_events" in inspect.signature(profile).parameters
              else {})
        if not trace_dir:
            from ray_tpu_torch._private.config import GlobalConfig

            base = GlobalConfig.tpu_profile_dir
            if not base:
                import tempfile

                base = tempfile.gettempdir()
            trace_dir = os.path.join(
                base, f"rtpu-tpu-profile-{os.getpid()}-{int(time.time())}")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        t0 = time.monotonic()
        if not _primed:
            _primed = _prime_cupti(profile, activities, kw)
        primed_s = time.monotonic() - t0
        with profile(activities=activities, **kw) as prof:
            window_open.set()
            try:
                time.sleep(max(float(duration_s), 0.0))
                torch.cuda.synchronize()
            finally:
                window_open.clear()
        prof.export_chrome_trace(path)
        return {"artifact": path, "duration_s": float(duration_s),
                "kernel_events": len(trace_kernel_events(path)),
                "primed_s": primed_s}
    finally:
        _trace_lock.release()


def trace_kernel_events(path: str, name: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """The CUDA kernel records of a Chrome trace ``capture_tpu_trace``
    wrote (``cat == "kernel"``), those whose name holds ``name`` if
    given."""
    import json

    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and (name is None or name in e.get("name", ""))]
