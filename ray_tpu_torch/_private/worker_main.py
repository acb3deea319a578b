"""Worker process entry point.

Role-equivalent to the reference's `default_worker.py` + `worker.main_loop`
(`_private/worker.py:869`): boot a core worker, register with the local
raylet, then serve task-execution RPCs forever. The process exits when its
raylet kills it, when `kill_self` arrives, or when the raylet connection is
lost (fate-sharing).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import JobID, WorkerID
from ray_tpu_torch._private.worker import MODE_WORKER, Worker, set_global_worker


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-host", required=True)
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--job-id", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--raylet-pid", type=int, default=0)
    args = parser.parse_args()

    # SIGUSR1 dumps all thread stacks to stderr (the worker log) — a
    # wedged cluster can be post-mortemed by signalling every daemon
    # (gcs_server/raylet register the same handler).
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # SIGUSR2 dumps parked-coroutine stacks + submit-queue state for
    # every event loop — faulthandler can't see awaits (rpc.py).
    from ray_tpu_torch._private.rpc import install_coroutine_dump_signal
    install_coroutine_dump_signal()

    # runtime_env working_dir: the raylet exports it when this worker's
    # pool was spawned for an env that sets one (env_vars arrive directly
    # in this process's environment, applied at spawn).
    wd = os.environ.get("RAY_TPU_WORKING_DIR")
    if wd and os.path.isdir(wd):
        os.chdir(wd)
        sys.path.insert(0, wd)

    worker = Worker(
        mode=MODE_WORKER,
        gcs_addr=(args.gcs_host, args.gcs_port),
        raylet_addr=(args.raylet_host, args.raylet_port),
        node_id=bytes.fromhex(args.node_id),
        job_id=JobID(bytes.fromhex(args.job_id)),
        worker_id=WorkerID(bytes.fromhex(args.worker_id)),
        session_dir=args.session_dir,
    )
    set_global_worker(worker)

    reply = worker.raylet.call(
        "register_worker", worker_id=worker.worker_id.binary(),
        port=worker.port, pid=os.getpid(), job_id=worker.job_id.binary())
    if not reply.get("ok"):
        print("raylet refused worker registration; exiting", file=sys.stderr)
        sys.exit(1)
    GlobalConfig.load_system_config(reply.get("system_config", "{}"))

    # Mirror the driver's import environment so by-reference pickled
    # functions (module-level in driver-local files) resolve here.
    try:
        job_info = worker.gcs.call("get_job_info",
                                   job_id=worker.job_id.binary(), timeout=10)
        if job_info:
            meta = job_info.get("metadata", {})
            for p in meta.get("sys_path", []):
                if p and p not in sys.path:
                    sys.path.append(p)
            cwd = meta.get("cwd")
            # runtime_env working_dir (chdir'd above) takes precedence over
            # mirroring the driver's cwd.
            if cwd and os.path.isdir(cwd) and not wd:
                os.chdir(cwd)
    except Exception:
        pass

    # Fate-share with the raylet. The PRIMARY signal is process
    # liveness (os.kill(pid, 0)) — it cannot false-positive when the
    # raylet is merely busy. RPC pings are only a backstop for a raylet
    # whose process is alive but whose server is permanently wedged,
    # and require a long consecutive-failure streak: a single missed
    # ping used to os._exit(1) here, and under a 500-actor spawn storm
    # after a 1M-task drain the raylet's loop stalls >10s, which
    # mass-suicided whole batches of healthy actor workers (actors
    # DEAD in bursts of ~36 while every node stayed ALIVE).
    def raylet_process_alive(pid: int) -> bool:
        # os.kill(pid, 0) alone treats a ZOMBIE raylet (crashed, not yet
        # reaped by its parent) as alive — read the state field instead.
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(") ", 1)[1].split()[0]
            return state != "Z"
        except OSError:
            return False

    ping_fails = 0
    while True:
        time.sleep(2.0)
        if args.raylet_pid and not raylet_process_alive(args.raylet_pid):
            os._exit(1)  # raylet process is gone (or a zombie)
        try:
            worker.raylet.call("node_stats", timeout=10)
            ping_fails = 0
        except Exception as e:
            # Instant refusal means nothing is listening — the raylet's
            # server is gone even if a pid lingers — so weigh it far
            # heavier than a timeout (a BUSY raylet times out, it does
            # not refuse). The RPC layer wraps ECONNREFUSED in
            # ConnectionLost, so match on the message.
            refused = "refused" in str(e).lower()
            if refused:
                ping_fails += 5
            elif not args.raylet_pid:
                ping_fails += 1
            else:
                # The raylet PROCESS is verifiably alive (liveness check
                # above) and merely too busy to answer in 10s. Weighting
                # these like refusals mass-suicided hundreds of healthy
                # workers during a 10^3-actor storm whose raylet loop
                # stalled 30s+ (respawns then fed the stall) — but a
                # PERMANENTLY wedged-yet-alive server must still
                # fate-share eventually, so timeouts count at 1/10
                # weight: ~60 min of CONSECUTIVE dead air to trip vs
                # ~1 min before.
                ping_fails += 0.1
            if ping_fails >= (30 if args.raylet_pid else 5):
                print(f"raylet unreachable (score {ping_fails}, last: "
                      f"{e}); exiting", file=sys.stderr, flush=True)
                os._exit(1)


if __name__ == "__main__":
    main()
