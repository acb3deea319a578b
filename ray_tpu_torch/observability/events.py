"""Cluster event schema registry — the failure-forensics vocabulary.

Reference: `src/ray/protobuf/event.proto` (structured export events) and
the `WorkerExitType` taxonomy consumed by `gcs_worker_manager`. Every
event the framework records in the GCS ClusterEventLog MUST use a type
declared here (``make_event`` raises on any other).

The taxonomy exists so a dead worker is diagnosable from the driver:
the raylet classifies each exit from the waitpid status (exit code vs.
signal, cross-checked against the memory monitor's kill list and the
pool's own intended retirements), and that classification rides the
worker-death error all the way into the exception message.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

SEVERITIES = ("INFO", "WARNING", "ERROR")

# Registered event types -> one-line description. One reviewable place;
# emission sites reference these names as string literals.
EVENT_TYPES: Dict[str, str] = {
    "WORKER_EXIT": "A worker process left the node's pool "
                   "(classified by exit taxonomy).",
    "ACTOR_DEATH": "An actor died permanently (restarts exhausted or "
                   "no_restart kill).",
    "ACTOR_RESTART": "An actor died and is being restarted.",
    "NODE_ADDED": "A raylet registered with the GCS.",
    "NODE_REMOVED": "A node was marked DEAD (drain, health-check "
                    "failure, ...).",
    "LEASE_RECLAIMED": "A raylet reclaimed a task-worker lease whose "
                       "owner died.",
    "TASK_RETRY": "A task attempt failed and is being retried.",
    "SPILL_PRESSURE": "An object store spilled under memory pressure.",
    "JOB_STARTED": "A driver registered a job.",
    "JOB_FINISHED": "A job was marked finished.",
    # Control-plane decisions: each carries the triggering metric
    # reading in its extra fields so the event log alone answers "why
    # did it scale / preempt".
    "AUTOSCALE_UP": "The serve autoscaler added replicas to a "
                    "deployment.",
    "AUTOSCALE_DOWN": "The serve autoscaler removed replicas from a "
                      "deployment.",
    "PREEMPT_RESCHEDULE": "The memory monitor preemptively retired the "
                          "largest leased worker before the OOM-kill "
                          "threshold; its task reschedules via the "
                          "normal retry path.",
    # Serve cost-accounting / SLO plane (observability/accounting.py +
    # the GCS accounting ring): the burn event carries the fast/slow
    # burn rates and attainment so the autoscaler / quota controllers
    # can act on it without a second lookup.
    "SLO_BURN": "A serve lane is burning its SLO error budget: both "
                "the fast and slow burn-rate windows exceed their "
                "thresholds for TTFT/TPOT attainment.",
    # Train goodput plane (observability/goodput.py + the GCS step
    # matrix): the straggler event names the dominant phase; the stall
    # event carries the stalled worker's thread stacks.
    "TRAIN_STRAGGLER": "A train worker's step time exceeded the pod "
                       "median by the straggler threshold; names the "
                       "dominant phase.",
    "TRAIN_STALL": "A train worker missed its step-report heartbeats; "
                   "carries the worker's auto-captured thread stacks.",
    # The program plane (observability/xla.py): the regression sentinel
    # compares every new program's counts and every sampled wall against
    # the function's baseline program.
    "PERF_REGRESSION": "A tracked program's FLOPs, peak device bytes, or "
                       "sampled wall drifted past xla_regression_ratio "
                       "times its baseline (the event names the "
                       "program and the drifted dimension).",
    # An actor that no live node can take stays queued while a running
    # autoscaler reads its demand (Ray keeps such an actor pending and
    # warns); one event per waiting actor.
    "ACTOR_PENDING": "An actor that no live node can fit outlived its "
                     "lease deadline and waits for the node a running "
                     "autoscaler is adding.",
}

# Worker exit taxonomy (reference: `WorkerExitType`). The raylet picks
# one per reaped worker; OOM_KILLED and INTENDED_EXIT take precedence
# over the raw waitpid status because the raylet itself caused those
# deaths (a SIGKILL it sent must not read as SYSTEM_ERROR).
WORKER_EXIT_TYPES = (
    "INTENDED_EXIT",   # clean exit 0, pool retirement, ray_tpu_torch.kill
    "USER_ERROR",      # nonzero exit code (uncaught exception, sys.exit)
    "SYSTEM_ERROR",    # killed by a signal the framework didn't send
    "OOM_KILLED",      # shot by the node memory monitor
    "PREEMPT_RESCHEDULE",  # proactively retired below the kill
                           # threshold; task retries elsewhere
    "NODE_DEATH",      # the whole node went away
)

# Default severity per event type; emitters may override (e.g. a
# WORKER_EXIT is INFO when intended, ERROR when OOM-killed).
DEFAULT_SEVERITY: Dict[str, str] = {
    "WORKER_EXIT": "WARNING",
    "ACTOR_DEATH": "ERROR",
    "ACTOR_RESTART": "WARNING",
    "NODE_ADDED": "INFO",
    "NODE_REMOVED": "ERROR",
    "LEASE_RECLAIMED": "WARNING",
    "TASK_RETRY": "WARNING",
    "SPILL_PRESSURE": "WARNING",
    "JOB_STARTED": "INFO",
    "JOB_FINISHED": "INFO",
    "AUTOSCALE_UP": "INFO",
    "AUTOSCALE_DOWN": "INFO",
    "PREEMPT_RESCHEDULE": "WARNING",
    "SLO_BURN": "WARNING",
    "TRAIN_STRAGGLER": "WARNING",
    "TRAIN_STALL": "ERROR",
    "PERF_REGRESSION": "WARNING",
    "ACTOR_PENDING": "WARNING",
}

_EXIT_SEVERITY = {
    "INTENDED_EXIT": "INFO",
    "USER_ERROR": "WARNING",
    "SYSTEM_ERROR": "ERROR",
    "OOM_KILLED": "ERROR",
    # Deliberate, recoverable: the task retries — an ERROR here would
    # page on the controller doing its job.
    "PREEMPT_RESCHEDULE": "WARNING",
    "NODE_DEATH": "ERROR",
}


def make_event(event_type: str, message: str,
               severity: Optional[str] = None,
               node_id: Optional[str] = None,
               **extra: Any) -> Dict[str, Any]:
    """Build a validated, JSON-able event record. ``node_id`` and all
    ``extra`` values must already be plain (hex strings, ints) — events
    flow to the dashboard's JSON endpoints unmodified."""
    if event_type not in EVENT_TYPES:
        raise ValueError(f"unregistered cluster event type {event_type!r}; "
                         f"declare it in ray_tpu_torch.observability.events")
    sev = severity or DEFAULT_SEVERITY[event_type]
    if sev not in SEVERITIES:
        raise ValueError(f"unknown severity {sev!r} (want one of "
                         f"{SEVERITIES})")
    event = {"type": event_type, "severity": sev, "message": message,
             "node_id": node_id, "ts": time.time()}
    event.update(extra)
    return event


def classify_worker_exit(returncode: Optional[int], *,
                         oom_killed: bool = False,
                         intended: bool = False,
                         preempted: bool = False) -> str:
    """Map a reaped worker's waitpid status to the exit taxonomy.

    Popen semantics: negative returncode = killed by that signal,
    0 = clean exit, positive = abnormal interpreter exit. The
    raylet-caused deaths override the raw status — the raylet SIGKILLs
    retired pool workers (intended), OOM victims, and memory-pressure
    preemptions. OOM wins over preemption: if the kill threshold fired
    on a worker already marked for preemption, the stronger verdict is
    the true one."""
    if oom_killed:
        return "OOM_KILLED"
    if preempted:
        return "PREEMPT_RESCHEDULE"
    if intended:
        return "INTENDED_EXIT"
    if returncode is None or returncode == 0:
        return "INTENDED_EXIT"
    if returncode < 0:
        return "SYSTEM_ERROR"
    return "USER_ERROR"


def exit_severity(exit_type: str) -> str:
    return _EXIT_SEVERITY.get(exit_type, "WARNING")


def format_exit_detail(info: Optional[Dict[str, Any]],
                       recent_events: Optional[List[Dict[str, Any]]] = None
                       ) -> str:
    """Render a worker-exit info record (raylet ``get_worker_exit_info``)
    plus recent same-node events into the suffix of a death error
    message. Returns "" when nothing is known."""
    if not info:
        return ""
    parts: List[str] = []
    exit_type = info.get("exit_type")
    if exit_type:
        code = info.get("exit_code")
        parts.append(f"exit type: {exit_type}"
                     + (f" (exit code {code})" if code is not None else ""))
    for key, label in (("last_lines", "last stdout lines"),
                       ("last_err_lines", "last stderr lines")):
        lines = info.get(key)
        if lines:
            body = "\n".join(f"    {ln}" for ln in lines)
            parts.append(f"{label}:\n{body}")
    if recent_events:
        body = "\n".join(
            f"    [{e.get('severity')}] {e.get('type')}: {e.get('message')}"
            for e in recent_events)
        parts.append(f"recent events on the node:\n{body}")
    if not parts:
        return ""
    return "\n  " + "\n  ".join(parts)
