"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch``, never
``jax`` and nothing of ``ray_tpu``. Tensor code is PyTorch; each TPU
kernel on a ported path is a kernel written by hand for ``sm_90a`` under
``ops/csrc/``, built at first use. Entry points run on the card unless
the caller passes ``device="cpu"`` (the tests do; the kernels' plain
versions run there).

Ported so far: the core runtime (tasks, actors, the object store with
``torch.Tensor`` payloads, the GCS with placement groups, the raylet with
the node's NVIDIA cards leased as the ``GPU`` resource under
``CUDA_VISIBLE_DEVICES``: ``init``, ``remote(num_gpus=...)``, ``get``,
``put``, ``wait``, ``kill``, ``get_actor``, ``get_gpu_ids``), the serving
data plane on the dense and paged KV layouts with speculative decoding
and the disaggregated prefill/decode tier (``models.llama``,
``ops.attention``, ``serve.llm``), Serve on that runtime (``serve``: the
controller, replicas on ``num_gpus`` of the card, ``DeploymentHandle``,
the LLM router with the cluster prefix index and the peer pull, and
``build_llm_app`` / ``build_routed_llm_app`` / ``build_disagg_llm_app``),
the serving engine's metrics, spans and cost meters, pushed to the GCS
(``observability``, ``util.metrics``, ``util.tracing``, ``util.state``),
training on one device (``ops.fused_loss``, ``parallel.train_step``, the
attention's backward kernels), ZeRO over ring collectives
(``parallel.zero``), Train on the runtime (``train``), and the
reference's collective API with its ranks as actors (``util.collective``:
the ``cuda`` backend runs the ring kernels with one process per rank on
the card, ``torch`` is gloo, ``shm`` the coordinator hub).

Not ported yet, each raising where it is asked for: ``runtime_env``, the
``ray_tpu_torch://`` client, ``dag``, the dashboard, the workers'
device-profile bracket, and Serve's ingress (``serve.start``,
``serve.start_grpc``). Importing the package imports no torch: a worker
that never touches a tensor never loads it.

Public API parity map (reference file:line):
  init/shutdown        ~ python/ray/_private/worker.py:1219
  remote/get/put/wait  ~ worker.py:3153/:2583/:2695/:2760
  kill/cancel          ~ worker.py:2941/:2972
  get_actor            ~ worker.py:2906
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch._private.worker import (
    MODE_DRIVER, Worker, global_worker, global_worker_or_none,
    set_global_worker,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"

_init_lock = threading.Lock()
_local_node = None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    include_dashboard: bool = False,
    _system_config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Start (or connect to) a cluster and attach this process as the driver."""
    global _local_node
    with _init_lock:
        if global_worker_or_none() is not None:
            if ignore_reinit_error:
                return {"already_initialized": True}
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to ignore")
        from ray_tpu_torch._private.node import Node
        from ray_tpu_torch._private.rpc import RpcClient

        if address is not None and "://" in address:
            raise NotImplementedError(
                "the thin client (ray_tpu_torch://) is not ported yet "
                "(ROADMAP A4, after the core runtime)")

        if address is None:
            node = Node(head=True, num_cpus=num_cpus, num_gpus=num_gpus,
                        resources=resources, labels=labels,
                        object_store_memory=object_store_memory,
                        system_config=_system_config,
                        include_dashboard=include_dashboard)
            _local_node = node
            gcs_addr = node.gcs_addr
            raylet_addr = node.raylet_addr
            node_id = node.node_id.binary()
            session_dir = node.session_dir
        else:
            host, port = address.rsplit(":", 1)
            gcs_addr = (host, int(port))
            probe = RpcClient(*gcs_addr)
            GlobalConfig.load_system_config(probe.call("get_system_config",
                                                       timeout=10))
            nodes = [n for n in probe.call("get_all_nodes", timeout=10)
                     if n["state"] == "ALIVE"]
            probe.close()
            if not nodes:
                raise ConnectionError(f"no alive nodes at {address}")
            raylet_addr = tuple(nodes[0]["addr"])
            node_id = nodes[0]["node_id"]
            session_dir = ""

        gcs = RpcClient(*gcs_addr)
        job_int = gcs.call("next_job_id", timeout=10)
        job_id = JobID.from_int(job_int)
        worker = Worker(mode=MODE_DRIVER, gcs_addr=gcs_addr,
                        raylet_addr=raylet_addr, node_id=node_id,
                        job_id=job_id, session_dir=session_dir)
        worker.namespace = namespace or f"job-{job_id.hex()}"
        set_global_worker(worker)
        import sys as _sys

        gcs.call("register_job", job_id=job_id.binary(),
                 driver_addr=worker.addr,
                 metadata={"namespace": worker.namespace,
                           # Workers mirror the driver's import environment
                           # (same-filesystem equivalent of the reference's
                           # working_dir runtime env).
                           "sys_path": list(_sys.path),
                           "cwd": os.getcwd()})
        gcs.close()
        if log_to_driver:
            _start_log_listener(gcs_addr, job_id.hex())
        return {"gcs_address": f"{gcs_addr[0]}:{gcs_addr[1]}",
                "node_id": node_id.hex(), "job_id": job_id.hex(),
                "session_dir": session_dir,
                "dashboard_url": getattr(_local_node, "dashboard_url", None)
                if _local_node is not None else None}


_log_listener_stop = None


def _start_log_listener(gcs_addr, job_id_hex: Optional[str] = None) -> None:
    """Subscribe to the "logs" pubsub channel and echo worker output
    (reference: the driver-side subscriber fed by `log_monitor.py`)."""
    global _log_listener_stop
    import sys
    import threading

    from ray_tpu_torch._private.log_monitor import echo_to_driver
    from ray_tpu_torch._private.rpc import RpcClient

    stop = threading.Event()
    _log_listener_stop = stop

    my_job = job_id_hex

    def run():
        client = None
        cursor = None
        while not stop.is_set():
            try:
                if client is None:
                    client = RpcClient(*gcs_addr)
                if cursor is None:
                    cursor = client.call("pubsub_seq", timeout=10)
                msgs = client.call("poll", channel="logs", cursor=cursor,
                                   wait_timeout=2.0, timeout=30)
                for seq, msg in msgs:
                    cursor = max(cursor, seq)
                    # Only this driver's job (other drivers echo their own).
                    if msg.get("job_id") not in (None, my_job):
                        continue
                    echo_to_driver(msg, msg.get("ip", "?"),
                                   sys.stderr.write)
            except Exception:
                # Transient GCS hiccup: drop the connection, retry. The
                # cursor survives so no lines are replayed.
                if client is not None:
                    try:
                        client.close()
                    except Exception:
                        pass
                    client = None
                stop.wait(1.0)
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    threading.Thread(target=run, daemon=True,
                     name="ray_tpu_log_listener").start()


def shutdown() -> None:
    global _local_node
    with _init_lock:
        if _log_listener_stop is not None:
            _log_listener_stop.set()
        w = global_worker_or_none()
        if w is not None:
            try:
                w.gcs.call("mark_job_finished", job_id=w.job_id.binary(),
                           timeout=5)
            except Exception:
                pass
            if _local_node is not None:
                try:  # local usage report (reference: usage_stats ping)
                    from ray_tpu_torch._private import usage_stats

                    # Opt-out guards the RPCs too, not just the write.
                    if usage_stats.usage_stats_enabled():
                        caps = w.gcs.call("cluster_resources", timeout=5)
                        n_nodes = len(
                            w.gcs.call("get_all_nodes", timeout=5) or [])
                        usage_stats.write_report(
                            _local_node.session_dir, {
                                "session_id": os.path.basename(
                                    _local_node.session_dir),
                                "num_nodes": n_nodes,
                                "num_cpus": caps.get("CPU"),
                                "num_gpus": caps.get("GPU"),
                            })
                except Exception:
                    pass
            try:
                w.shutdown()
            finally:
                # Even a failed teardown must drop the global worker, or
                # the next init(ignore_reinit_error=True) silently reuses
                # a half-dead cluster (observed as cross-module test
                # leakage: later suites inherited a stale session).
                set_global_worker(None)
        if _local_node is not None:
            try:
                _local_node.shutdown()
            finally:
                _local_node = None


def is_initialized() -> bool:
    return global_worker_or_none() is not None


def remote(*args, **options) -> Union[RemoteFunction, ActorClass]:
    """``@ray_tpu_torch.remote`` / ``@ray_tpu_torch.remote(num_gpus=1, ...)``."""
    if len(args) == 1 and not options and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes only keyword options")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        return RemoteFunction(target, options)

    return decorator


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    single = isinstance(refs, ObjectRef)
    batch = [refs] if single else list(refs)
    for r in batch:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
    values = global_worker().get_objects(batch, timeout)
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return global_worker().wait(refs, num_returns, timeout, fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    global_worker().kill_actor(actor._actor_id, no_restart)


def cancel(ref: Union[ObjectRef, ObjectRefGenerator], *,
           force: bool = False) -> None:
    if isinstance(ref, ObjectRefGenerator):
        ref = ref._ref0
    global_worker().cancel_task(ref, force)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    return global_worker().get_actor(name, namespace)


def get_gpu_ids() -> List[int]:
    """The GPU ids the raylet leased to the current task or actor (the
    ``CUDA_VISIBLE_DEVICES`` it runs under); [] in the driver."""
    return get_runtime_context().get_gpu_ids()


# -- cluster state ----------------------------------------------------------

def nodes() -> List[Dict[str, Any]]:
    out = []
    for n in global_worker().gcs.call("get_all_nodes", timeout=10):
        out.append({
            "NodeID": n["node_id"].hex(), "Alive": n["state"] == "ALIVE",
            "Resources": n["total"], "Available": n["available"],
            "Labels": n["labels"], "RayletAddr": n["addr"],
        })
    return out


def cluster_resources() -> Dict[str, float]:
    return global_worker().gcs.call("cluster_resources", timeout=10)


def available_resources() -> Dict[str, float]:
    return global_worker().gcs.call("available_resources", timeout=10)


def task_events(limit: Optional[int] = None) -> List[Dict]:
    """Raw task lifecycle events from the head's ring buffer (all of it by
    default — the server-side default limit of 1000 would silently drop
    older tasks from timelines)."""
    from ray_tpu_torch._private.config import GlobalConfig
    return global_worker().gcs.call(
        "get_task_events", timeout=30,
        limit=limit or GlobalConfig.task_events_buffer_size)


def timeline(filename: Optional[str] = None) -> List[Dict]:
    """Chrome-trace-format task timeline (reference: `ray timeline`,
    `scripts/scripts.py:1875` dumping chrome://tracing JSON from GCS task
    events). Returns the trace events; also writes JSON to `filename` if
    given. The same rendering backs the dashboard's `GET /api/timeline`
    (`observability/timeline.py`)."""
    from ray_tpu_torch.observability.timeline import build_chrome_trace

    trace = build_chrome_trace(task_events())
    if filename:
        import json as _json
        with open(filename, "w") as f:
            _json.dump(trace, f)
    return trace


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "put", "get", "wait",
    "kill", "cancel", "get_actor", "get_gpu_ids", "method", "nodes",
    "cluster_resources",
    "available_resources", "get_runtime_context", "ObjectRef", "ActorHandle",
    "exceptions", "timeline", "task_events", "__version__",
]
