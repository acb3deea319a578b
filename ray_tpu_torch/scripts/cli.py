"""ray_tpu_torch CLI — cluster lifecycle, state inspection, jobs, metrics.

Reference: `python/ray/scripts/scripts.py` (`ray start/stop/status`),
`python/ray/util/state` CLI (`ray list ...`), and the job CLI
(`dashboard/modules/job/cli.py`). argparse-based (no click in the image).
A node's cards are its ``GPU`` resource: ``--num-gpus`` where the
reference has ``--num-tpus``; without it ``start`` counts the host's
cards.

Usage:
  python -m ray_tpu_torch start --head [--num-cpus N] [--num-gpus G] [--port P] [--block]
  python -m ray_tpu_torch start --address HOST:PORT [--num-cpus N] [--num-gpus G]
  python -m ray_tpu_torch stop
  python -m ray_tpu_torch up|down|attach <cluster.yaml>
  python -m ray_tpu_torch status [--address HOST:PORT]
  python -m ray_tpu_torch list nodes|actors|workers|jobs|tasks|pgs|objects
  python -m ray_tpu_torch job submit -- <shell entrypoint>
  python -m ray_tpu_torch job status|logs <submission-id>
  python -m ray_tpu_torch job list
  python -m ray_tpu_torch metrics
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Any, List, Optional


def _address(args) -> Optional[str]:
    return (getattr(args, "address", None)
            or os.environ.get("RAY_TPU_ADDRESS"))


def _connect(args):
    import ray_tpu_torch

    addr = _address(args)
    if addr:
        ray_tpu_torch.init(address=addr)
    else:
        raise SystemExit(
            "no cluster address: pass --address or set RAY_TPU_ADDRESS")
    return ray_tpu_torch


def _print_table(rows: List[dict]) -> None:
    if not rows:
        print("(empty)")
        return
    cols = list(rows[0].keys())
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    print("  ".join("-" * widths[c] for c in cols))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))


# ----------------------------------------------------------------- commands

def cmd_start(args) -> None:
    from ray_tpu_torch._private.node import Node

    if args.head:
        node = Node(head=True, num_cpus=args.num_cpus,
                    num_gpus=args.num_gpus, fate_share=False,
                    gcs_port=args.port or 0,
                    include_dashboard=not getattr(
                        args, "no_dashboard", False))
        addr = "%s:%d" % node.gcs_addr
        print(f"started head node; cluster address: {addr}")
        print(f"session dir: {node.session_dir}")
        if node.dashboard_url:
            print(f"dashboard: {node.dashboard_url}")
        print(f"  export RAY_TPU_ADDRESS={addr}")
    else:
        addr = _address(args)
        if not addr:
            raise SystemExit("start requires --head or --address")
        host, port = addr.rsplit(":", 1)
        resources = (json.loads(args.resources)
                     if getattr(args, "resources", None) else None)
        labels = (json.loads(args.labels)
                  if getattr(args, "labels", None) else None)
        node = Node(head=False, gcs_addr=(host, int(port)),
                    num_cpus=args.num_cpus, num_gpus=args.num_gpus,
                    resources=resources, labels=labels,
                    fate_share=False)
        print(f"joined cluster at {addr} as node {node.node_id.hex()[:12]}")
    if args.block:
        try:
            signal.pause()
        except KeyboardInterrupt:
            pass
        finally:
            node.shutdown()


# The port's daemons only: the JAX package's (``ray_tpu._private.…``)
# on the same host are another cluster's.
STOP_PATTERN = r"ray_tpu_torch\._private\.(gcs_server|raylet|worker_main)"


def cmd_stop(args) -> None:
    import subprocess

    out = subprocess.run(["pkill", "-f", STOP_PATTERN], capture_output=True)
    print("stopped" if out.returncode == 0 else "no daemons found")


# --------------------------------------------------------- cluster launcher

def _launcher_state_path(cluster_name: str) -> str:
    import tempfile

    return os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_torch-cluster-{cluster_name}.json")


def cmd_up(args) -> None:
    """Launch a cluster from a YAML config and run the autoscaler monitor
    (reference: `ray up` — `autoscaler/_private/commands.py:create_or_update_cluster`)."""
    from ray_tpu_torch._private.node import Node
    from ray_tpu_torch.autoscaler.config import load_cluster_config
    from ray_tpu_torch.autoscaler.pod_autoscaler import run_monitor_loop

    cfg = load_cluster_config(args.config)
    head_type = cfg.get("head_node_type")
    head_res = {}
    if head_type:
        head_res = dict(
            cfg["available_node_types"][head_type].get("resources", {}))
    # GPU is given even when it is 0: a head type without cards must not
    # claim the host's.
    node = Node(head=True, num_cpus=int(head_res.pop("CPU", args.num_cpus)),
                num_gpus=int(head_res.pop("GPU", 0)), resources=head_res,
                fate_share=False)
    addr = "%s:%d" % node.gcs_addr
    state = {"cluster_name": cfg["cluster_name"], "address": addr,
             "session_dir": node.session_dir, "config": args.config,
             "head_pid": os.getpid()}
    with open(_launcher_state_path(cfg["cluster_name"]), "w") as f:
        json.dump(state, f)
    print(f"cluster '{cfg['cluster_name']}' is up; address: {addr}")
    print(f"session dir: {node.session_dir}")
    print(f"  attach with: python -m ray_tpu_torch attach {args.config}")
    print(f"  export RAY_TPU_ADDRESS={addr}")
    stop = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *a: stop.update(flag=True))
    try:
        run_monitor_loop(node.gcs_addr, cfg, node.session_dir,
                         stop_check=lambda: stop["flag"])
    except KeyboardInterrupt:
        pass
    finally:
        node.shutdown()
        try:
            os.unlink(_launcher_state_path(cfg["cluster_name"]))
        except OSError:
            pass


# How long `down` waits for the head: the monitor's last pass (5 s), then
# each node's and the head's daemons (2 s of SIGTERM each).
DOWN_WAIT_S = 120.0


def cmd_down(args) -> None:
    """Tear down a launched cluster (reference: `ray down`), and wait
    until its head process, which terminates the autoscaled nodes and then
    its own daemons, has exited."""
    from ray_tpu_torch.autoscaler.config import load_cluster_config

    cfg = load_cluster_config(args.config)
    path = _launcher_state_path(cfg["cluster_name"])
    if not os.path.exists(path):
        raise SystemExit(f"no running cluster '{cfg['cluster_name']}' found")
    with open(path) as f:
        state = json.load(f)
    try:
        os.kill(state["head_pid"], signal.SIGTERM)
        print(f"cluster '{cfg['cluster_name']}' shutting down "
              f"(head pid {state['head_pid']})")
    except ProcessLookupError:
        print("head process already gone; cleaning up state")
    deadline = time.monotonic() + DOWN_WAIT_S
    while _pid_alive(state["head_pid"]):
        if time.monotonic() > deadline:
            raise SystemExit(f"head pid {state['head_pid']} still running "
                             f"after {DOWN_WAIT_S:.0f} s")
        time.sleep(0.1)
    try:
        os.unlink(path)
    except OSError:
        pass


def _pid_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def cmd_attach(args) -> None:
    """Open a Python REPL connected to the launched cluster
    (reference: `ray attach` opens a shell on the head)."""
    from ray_tpu_torch.autoscaler.config import load_cluster_config

    cfg = load_cluster_config(args.config)
    path = _launcher_state_path(cfg["cluster_name"])
    if not os.path.exists(path):
        raise SystemExit(f"no running cluster '{cfg['cluster_name']}' found")
    with open(path) as f:
        state = json.load(f)
    if args.print_address:
        print(state["address"])
        return
    import code

    import ray_tpu_torch

    ray_tpu_torch.init(address=state["address"])
    banner = (f"Attached to cluster '{cfg['cluster_name']}' at "
              f"{state['address']}.\nray_tpu_torch is initialized — e.g. "
              "ray_tpu_torch.cluster_resources()")
    code.interact(banner=banner, local={"ray_tpu_torch": ray_tpu_torch})


def cmd_status(args) -> None:
    rt = _connect(args)
    from ray_tpu_torch.util import state

    s = state.summary()
    print(f"nodes: {s['nodes_alive']} alive / {s['nodes_dead']} dead")
    print(f"actors: {s['actors']}   workers: {s['workers']}")
    print("resources:")
    total, avail = s["cluster_resources"], s["available_resources"]
    for key in sorted(total):
        print(f"  {avail.get(key, 0):.1f}/{total[key]:.1f} {key}")
    rt.shutdown()


def cmd_list(args) -> None:
    rt = _connect(args)
    from ray_tpu_torch.util import state

    kind = args.kind
    fns = {
        "nodes": state.list_nodes, "actors": state.list_actors,
        "workers": state.list_workers, "jobs": state.list_jobs,
        "tasks": state.list_tasks, "pgs": state.list_placement_groups,
        "placement-groups": state.list_placement_groups,
        "objects": state.list_objects,
    }
    rows = fns[kind]()
    if args.json:
        print(json.dumps(rows, default=str, indent=2))
    else:
        _print_table([{k: v for k, v in r.items()
                       if not isinstance(v, (dict, list))} for r in rows])
    rt.shutdown()


def cmd_job(args) -> None:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    # http:// address = dashboard job REST API (off-cluster submission,
    # no driver connection needed); otherwise connect as a driver.
    addr = getattr(args, "address", None) or os.environ.get(
        "RAY_TPU_ADDRESS", "")
    if addr.startswith("http"):
        rt = None
        client = JobSubmissionClient(address=addr)
    else:
        rt = _connect(args)
        client = JobSubmissionClient()
    if args.job_cmd == "submit":
        parts = list(args.entrypoint)
        if parts and parts[0] == "--":
            parts = parts[1:]
        entrypoint = " ".join(parts)
        sid = client.submit_job(
            entrypoint=entrypoint,
            runtime_env=({"working_dir": args.working_dir}
                         if args.working_dir else None))
        print(f"submitted: {sid}")
        if args.wait:
            status = client.wait_until_finished(sid, timeout=args.timeout)
            print(f"{sid}: {status}")
            print(client.get_job_logs(sid))
            if status != "SUCCEEDED":
                sys.exit(1)
    elif args.job_cmd == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.submission_id))
    elif args.job_cmd == "stop":
        print("stopped" if client.stop_job(args.submission_id)
              else "not running")
    elif args.job_cmd == "list":
        _print_table(client.list_jobs())
    if rt is not None:
        rt.shutdown()


def cmd_metrics(args) -> None:
    rt = _connect(args)
    from ray_tpu_torch._private.worker import global_worker

    print(global_worker().gcs.call("metrics_text", timeout=30), end="")
    rt.shutdown()


def cmd_serve(args) -> None:
    rt = _connect(args)
    from ray_tpu_torch import serve

    if args.serve_cmd == "deploy":
        names = serve.deploy_config_file(args.config)
        print(f"deployed applications: {', '.join(names)}")
    elif args.serve_cmd == "run":
        app = serve.import_application(args.import_path)
        serve.run(app, name=args.name,
                  route_prefix=args.route_prefix)
        print(f"application '{args.name}' running "
              f"(ingress: {args.import_path})")
    elif args.serve_cmd == "status":
        apps = serve.list_applications()
        if not apps:
            print("serve is not running (no applications deployed)")
            rt.shutdown()
            return
        rows = []
        for app in apps:
            for d in serve.status(app):
                rows.append({"app": app, **d})
        _print_table(rows)
    elif args.serve_cmd == "shutdown":
        serve.shutdown()
        print("serve shut down")
    rt.shutdown()


def cmd_summary(args) -> None:
    rt = _connect(args)
    from ray_tpu_torch.util import state

    rows = (state.summary_tasks() if args.kind == "tasks"
            else state.summary_actors())
    _print_table(rows)
    rt.shutdown()


def cmd_timeline(args) -> None:
    rt = _connect(args)
    trace = rt.timeline(filename=args.output)
    print(f"wrote {len(trace)} trace events to {args.output} "
          f"(open in chrome://tracing or https://ui.perfetto.dev)")
    rt.shutdown()


# --------------------------------------------------------------------- main

def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    parser.add_argument("--address", default=None,
                        help="cluster address HOST:PORT "
                             "(default: $RAY_TPU_ADDRESS)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    # SUPPRESS: absent here must not clobber a globally-passed
    # `ray_tpu_torch --address X start` (subparser defaults overwrite the
    # shared namespace).
    p.add_argument("--address", default=argparse.SUPPRESS,
                   help="cluster GCS address to join (worker mode)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-cpus", type=int, default=None)
    p.add_argument("--num-gpus", type=int, default=None,
                   help="the node's GPU count (default: its cards)")
    p.add_argument("--no-dashboard", action="store_true",
                   help="skip starting the dashboard head")
    p.add_argument("--resources", default=None,
                   help="JSON custom resources for this node, e.g. "
                        "'{\"bigmem\": 1}'")
    p.add_argument("--labels", default=None,
                   help="JSON node labels (the cloud provider tags joined "
                        "nodes with their provider group this way)")
    p.add_argument("--block", action="store_true",
                   help="stay attached; Ctrl-C stops the node")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop this host's ray_tpu_torch daemons")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("up", help="launch a cluster from a YAML config "
                                  "and run its autoscaler")
    p.add_argument("config")
    p.add_argument("--num-cpus", type=int, default=os.cpu_count() or 1)
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="tear down a launched cluster")
    p.add_argument("config")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("attach", help="REPL attached to a launched cluster")
    p.add_argument("config")
    p.add_argument("--print-address", action="store_true",
                   help="print the cluster address and exit")
    p.set_defaults(fn=cmd_attach)

    p = sub.add_parser("status", help="cluster summary")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("kind", choices=["nodes", "actors", "workers", "jobs",
                                    "tasks", "pgs", "placement-groups",
                                    "objects"])
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("job", help="job submission")
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    ps = jsub.add_parser("submit")
    ps.add_argument("--working-dir", default=None)
    ps.add_argument("--wait", action="store_true")
    ps.add_argument("--timeout", type=float, default=600.0)
    ps.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="shell entrypoint (after --)")
    for name in ("status", "logs", "stop"):
        pj = jsub.add_parser(name)
        pj.add_argument("submission_id")
    jsub.add_parser("list")
    p.set_defaults(fn=cmd_job)

    p = sub.add_parser("metrics", help="prometheus metrics text")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("timeline", help="dump chrome-trace task timeline")
    p.add_argument("-o", "--output", default="timeline.json")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("summary", help="state rollups")
    p.add_argument("kind", choices=["tasks", "actors"])
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("serve", help="model-serving control")
    ssub = p.add_subparsers(dest="serve_cmd", required=True)
    pd = ssub.add_parser("deploy", help="deploy a YAML config file")
    pd.add_argument("config")
    pr = ssub.add_parser("run", help="run an app by import path")
    pr.add_argument("import_path", help="module.sub:app")
    pr.add_argument("--name", default="default")
    pr.add_argument("--route-prefix", default=None)
    ssub.add_parser("status")
    ssub.add_parser("shutdown")
    p.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
