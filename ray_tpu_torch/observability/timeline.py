"""Chrome-trace builder over GCS task events.

The one rendering of the head's task-event ring buffer, shared by
``ray_tpu_torch.timeline()`` (driver API) and the dashboard's
``GET /api/timeline`` (download endpoint). Output loads in
chrome://tracing / Perfetto:

- ``cat:"task"``     one complete (``ph:"X"``) event per task
  execution, RUNNING -> FINISHED/FAILED, rowed by worker address.
  Still-running tasks render to the ring's newest timestamp (not
  ``time.time()`` at render — repeated downloads of a live job must be
  monotone) and carry ``args.state="RUNNING"``, ``args.incomplete``.
- ``cat:"submit"``   the submission->execution path, rowed by the
  submitting driver/worker pid. With scheduling-phase events present
  (PENDING -> LEASE_GRANTED -> WORKER_STARTED -> ARGS_READY ->
  RUNNING) it renders one segment per phase hop (named
  ``<task>:<phase>``, ``args.phase`` = lease_grant / worker_start /
  args_fetch / exec_start); otherwise the single PENDING -> RUNNING
  arrow.
- ``cat:"span"``     user spans from ``ray_tpu_torch.util.tracing`` —
  including the telemetry plane's ``jit_compile`` and per-request
  ``llm.*`` lifecycle spans.
"""

from __future__ import annotations

from typing import Dict, List

from ray_tpu_torch.observability.profiling import (
    SCHED_PHASES,
    SCHED_SEGMENT_LABELS,
)


def build_chrome_trace(events: List[Dict]) -> List[Dict]:
    by_task: Dict[bytes, Dict[str, Dict]] = {}
    spans: List[Dict] = []
    horizon = 0.0  # ring's newest timestamp = render-time "now"
    for e in events:
        ts = e.get("ts")
        if isinstance(ts, (int, float)) and ts > horizon:
            horizon = ts
        if e["state"] == "SPAN":
            spans.append(e)
            continue
        slot = by_task.setdefault(e["task_id"], {})
        prev = slot.get(e["state"])
        # Duplicate states keep the newest event: the owner stamps a
        # push-time RUNNING (so live/crashed tasks render at all) and,
        # on reply, the worker's exec-start-accurate RUNNING — the
        # refined one wins deterministically.
        if prev is None or e["ts"] >= prev["ts"]:
            slot[e["state"]] = e
    trace: List[Dict] = []
    for tid, states in by_task.items():
        run, end = states.get("RUNNING"), (
            states.get("FINISHED") or states.get("FAILED"))
        if not run:
            continue
        worker = ":".join(map(str, run.get("worker_addr", ["?"])))
        # Incomplete (still-RUNNING) tasks extend to the ring horizon:
        # a function of the event data only, so re-rendering the same
        # ring yields the same trace and successive downloads of a
        # live job only ever grow the bar.
        end_ts = end["ts"] if end else max(horizon, run["ts"])
        args = {"task_id": tid.hex(),
                "state": end["state"] if end else "RUNNING"}
        if not end:
            args["incomplete"] = True
        trace.append({
            "name": run["name"], "cat": "task", "ph": "X",
            "ts": run["ts"] * 1e6, "dur": max(end_ts - run["ts"], 0) * 1e6,
            "pid": worker, "tid": worker,
            "args": args,
        })
        owner = states.get("PENDING") or run
        drv = f"driver-{owner.get('owner_pid', '?')}"
        present = [(p, states[p]) for p in SCHED_PHASES if p in states]
        if len(present) >= 2:
            # Segmented submit arrows: one bar per phase hop between
            # consecutive *present* phases (a phase evicted from the
            # ring widens the next hop instead of dropping it).
            for (_, ea), (pb, eb) in zip(present, present[1:]):
                label = SCHED_SEGMENT_LABELS.get(pb, pb)
                trace.append({
                    "name": f"{run['name']}:{label}", "cat": "submit",
                    "ph": "X", "ts": ea["ts"] * 1e6,
                    "dur": max(eb["ts"] - ea["ts"], 0) * 1e6,
                    "pid": drv, "tid": drv,
                    "args": {"task_id": tid.hex(), "phase": label},
                })
    for e in spans:  # user spans from ray_tpu_torch.util.tracing
        trace.append({
            "name": e["name"], "cat": "span", "ph": "X",
            "ts": e["ts"] * 1e6, "dur": max(e.get("dur", 0), 0) * 1e6,
            "pid": f"spans-{e.get('owner_pid', '?')}",
            "tid": e["task_id"].hex()[:12],
            "args": e.get("attrs", {}),
        })
    return trace
