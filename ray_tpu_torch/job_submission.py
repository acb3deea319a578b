"""Job submission — run driver scripts on a cluster under supervision.

Reference: `dashboard/modules/job/job_manager.py` (JobManager spawns a
JobSupervisor actor per job; the supervisor runs the entrypoint as a
subprocess, captures logs, and records terminal status) + `job/sdk.py`
(JobSubmissionClient).

A job's ``runtime_env`` is the supervisor's: its worker starts inside
the env (``env_vars`` set, a ``working_dir`` unpacked from the GCS and
made its cwd, ``py_modules`` on its path), and the entrypoint inherits
that. The supervisor's worker, like every worker of the port, starts
with ``CUDA_VISIBLE_DEVICES=""``, so the entrypoint's process holds no
card: a job reaches the GPU through the actors and tasks it leases
(``num_gpus=``).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_KV_NS = "job_submissions"


@ray_tpu_torch.remote(num_cpus=0.5, max_concurrency=2)
class JobSupervisor:
    """Runs one job's entrypoint as a child process and reports status.

    ``max_concurrency=2`` so ``stop()`` can be delivered while ``run()``
    is blocked in ``proc.wait()`` — the stop must execute on the node
    that owns the child process (a client-side ``os.kill`` only works
    when client and supervisor share a machine; ADVICE r4 medium).
    """

    def __init__(self):
        import threading

        self._proc: Optional[subprocess.Popen] = None
        # Closes the stop-before-spawn race: stop() sets _stopped under
        # the lock; run() checks it under the same lock around Popen, so
        # an early stop() can never let the child spawn afterwards.
        self._stopped = False
        self._lock = threading.Lock()

    def stop(self, grace_s: float = 3.0) -> bool:
        """Terminate this job's entrypoint process group: SIGTERM, a
        grace window, then SIGKILL. Runs where the child lives, so it is
        correct on multi-node clusters and for off-cluster HTTP clients.
        Returns True iff the job can no longer run (process killed, or
        spawn permanently suppressed)."""
        import signal

        with self._lock:
            self._stopped = True
            proc = self._proc
        if proc is None:
            return True  # run() will see _stopped and never spawn
        if proc.poll() is not None:
            return True  # already exited
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (OSError, ProcessLookupError):
            try:
                proc.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.1)
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                try:
                    proc.kill()
                except Exception:
                    pass
        return True

    def run(self, submission_id: str, entrypoint: str, gcs_addr: str) -> int:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()

        def put_status(**fields):
            record = json.loads(
                w.gcs.call("kv_get", namespace=_KV_NS,
                           key=submission_id) or b"{}")
            record.update(fields)
            w.gcs.call("kv_put", namespace=_KV_NS, key=submission_id,
                       value=json.dumps(record).encode())

        log_path = os.path.join(
            w.session_dir or "/tmp", "logs",
            f"job-{submission_id}.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        child_env = dict(os.environ)
        child_env["RAY_TPU_ADDRESS"] = gcs_addr
        # The driver must import this framework no matter its cwd/script
        # location (equivalent of a pip-installed package).
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        child_env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + [p for p in
                          child_env.get("PYTHONPATH", "").split(os.pathsep)
                          if p])
        with open(log_path, "wb") as log:
            with self._lock:
                if self._stopped:
                    # stop_job() beat us here: never spawn.
                    return -1
            # Spawn OUTSIDE the lock: fork+exec of a shell can take tens
            # of ms and stop() queues on the same lock — holding it here
            # stalls every concurrent stop/status call for the spawn's
            # duration. The stop-before-spawn race stays closed below: a
            # stop() landing mid-spawn either sees _proc once published,
            # or we see _stopped and apply its verdict to the fresh
            # child ourselves.
            # Own session/process group: stop() kills the whole tree.
            proc = subprocess.Popen(
                entrypoint, shell=True, stdout=log,
                stderr=subprocess.STDOUT, env=child_env,
                start_new_session=True)
            with self._lock:
                self._proc = proc
                stopped_now = self._stopped
            if stopped_now:
                # stop() raced the spawn before _proc was visible: kill
                # the process group it could not see.
                import signal

                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    try:
                        proc.kill()
                    except Exception:
                        pass
                proc.wait()  # graftlint: disable=deadlock-unbounded-wait
                return -1
            put_status(status="RUNNING", log_path=log_path,
                       start_time=time.time(), pid=os.getpid(),
                       child_pid=proc.pid)  # same-node stop fallback
            # Unbounded by design: a job's entrypoint runs for as long
            # as the user's workload does; stop_job() is the bound.
            rc = proc.wait()  # graftlint: disable=deadlock-unbounded-wait
        record = json.loads(
            w.gcs.call("kv_get", namespace=_KV_NS,
                       key=submission_id) or b"{}")
        if record.get("status") == "STOPPED" or self._stopped:
            return rc  # stop_job already wrote the terminal state
        put_status(status="SUCCEEDED" if rc == 0 else "FAILED",
                   returncode=rc, end_time=time.time())
        return rc


class JobSubmissionClient:
    """Submit/inspect jobs.

    Two transports (reference: `job/sdk.py`): with no address, talks to
    the initialized in-process cluster connection; with an ``http://``
    address, talks to the dashboard head's job REST API — the off-cluster
    path (`dashboard/modules/job/job_head.py`).
    """

    def __init__(self, address: Optional[str] = None):
        self._http = None
        if address and address.startswith("http"):
            self._http = address.rstrip("/")
            return
        from ray_tpu_torch._private.worker import global_worker

        self._worker = global_worker()

    # ---- HTTP transport ---------------------------------------------------
    def _http_json(self, method: str, path: str, body=None):
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._http + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[Dict[str, Any]] = None) -> str:
        """Start ``entrypoint`` (a shell command) under a supervisor.
        ``runtime_env`` is the supervisor's environment, which the
        entrypoint inherits: its ``env_vars`` and, as its cwd, its
        ``working_dir``. Over HTTP the spec goes as written, and the
        head's own client packages a local ``working_dir`` (the head
        must see the path)."""
        if self._http:
            return self._http_json("POST", "/api/job_submissions", {
                "entrypoint": entrypoint, "submission_id": submission_id,
                "runtime_env": runtime_env,
            })["submission_id"]
        submission_id = submission_id or f"job_{uuid.uuid4().hex[:10]}"
        gcs_addr = "%s:%d" % self._worker.gcs_addr
        runtime_env = self._worker._prepare_runtime_env(runtime_env)
        record = {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": "PENDING",
            "submit_time": time.time(),
        }
        if runtime_env:
            record["runtime_env"] = runtime_env
        self._worker.gcs.call(
            "kv_put", namespace=_KV_NS, key=submission_id,
            value=json.dumps(record).encode())
        supervisor = JobSupervisor.options(
            name=f"_job_supervisor:{submission_id}",
            lifetime="detached", runtime_env=runtime_env).remote()
        # Fire and track: the ref resolves when the job process exits.
        self._refs = getattr(self, "_refs", {})
        self._refs[submission_id] = supervisor.run.remote(
            submission_id, entrypoint, gcs_addr)
        return submission_id

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id).get("status", "UNKNOWN")

    def get_job_info(self, submission_id: str) -> Dict[str, Any]:
        if self._http:
            return self._http_json(
                "GET", f"/api/job_submissions/{submission_id}")
        return self._record(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        if self._http:
            return self._http_json(
                "GET", f"/api/job_submissions/{submission_id}/logs")["logs"]
        path = self._record(submission_id).get("log_path")
        if not path or not os.path.exists(path):
            return ""
        with open(path, "r", errors="replace") as f:
            return f.read()

    def stop_job(self, submission_id: str) -> bool:
        """Kill the job's entrypoint process and mark it STOPPED."""
        if self._http:
            return self._http_json(
                "POST", f"/api/job_submissions/{submission_id}/stop"
            ).get("stopped", False)
        record = self._record(submission_id)
        if record.get("status") in ("SUCCEEDED", "FAILED", "STOPPED"):
            return False
        # Terminal state FIRST: the supervisor checks for STOPPED before
        # writing its own terminal status, so writing before the kill
        # closes the race where its FAILED overwrites our STOPPED.
        record.update(status="STOPPED", end_time=time.time())
        self._worker.gcs.call(
            "kv_put", namespace=_KV_NS, key=submission_id,
            value=json.dumps(record).encode())
        # Route the kill through the supervisor: it owns the child and
        # runs on the child's node, so this is correct on multi-node
        # clusters (a client-side os.kill only ever worked same-node).
        stopped_via_supervisor = False
        sup = None
        try:
            sup = ray_tpu_torch.get_actor(f"_job_supervisor:{submission_id}")
            stopped_via_supervisor = bool(
                ray_tpu_torch.get(sup.stop.remote(), timeout=30))
        except Exception:
            pass
        if not stopped_via_supervisor:
            # Same-node fallback when the supervisor is unreachable.
            pid = record.get("child_pid")
            if pid:
                try:
                    os.kill(pid, 15)
                except OSError:
                    pass
        if sup is not None:
            try:
                ray_tpu_torch.kill(sup)
            except Exception:
                pass
        return True

    def list_jobs(self) -> List[Dict[str, Any]]:
        if self._http:
            return self._http_json("GET", "/api/job_submissions")
        keys = self._worker.gcs.call("kv_keys", namespace=_KV_NS)
        return [self._record(k if isinstance(k, str) else k.decode())
                for k in keys]

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 600.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(0.5)
        raise TimeoutError(
            f"job {submission_id} still {status} after {timeout}s")

    def _record(self, submission_id: str) -> Dict[str, Any]:
        raw = self._worker.gcs.call("kv_get", namespace=_KV_NS,
                                    key=submission_id)
        if raw is None:
            raise KeyError(f"no such job: {submission_id}")
        return json.loads(raw)
