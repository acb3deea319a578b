"""Public serve API: @serve.deployment, serve.run, handles, status: the
port's copy of ``ray_tpu/serve/api.py``.

Reference: `serve/api.py` (`serve.run :521`), `serve/deployment.py`
(@deployment decorator producing Deployment objects whose `.bind()` builds
an Application graph). A replica's share of the card is ``num_gpus``
(whole or a fraction in (0, 1), leased by the raylet as ``GPU``), where
the reference's is ``num_tpus``; ``num_tpus`` raises as it does on any
remote. ``start`` and ``start_grpc`` start the HTTP and gRPC ingress.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.remote_function import reject_num_tpus
from ray_tpu_torch.serve.handle import DeploymentHandle

_PROXY_NAME = "SERVE_PROXY"


@dataclasses.dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: Any = 1          # int or "auto" (autoscaling defaults)
    num_cpus: float = 1
    num_gpus: float = 0
    route_prefix: Optional[str] = None
    # Per-replica concurrency (reference: max_ongoing_requests) — maps to
    # the replica actor's max_concurrency; also what @serve.batch needs to
    # see concurrent requests at all.
    max_ongoing_requests: int = 8
    # Keys (see serve/_private/autoscale.py AUTOSCALING_DEFAULTS):
    # {"min_replicas", "max_replicas", "target_ongoing_requests",
    #  "upscale_delay_s", "downscale_delay_s", "queue_wait_target_s",
    #  "slot_utilization_target"}
    autoscaling_config: Optional[Dict[str, Any]] = None
    # Generator deployments: HTTP responses stream chunk-by-chunk and
    # handles default to DeploymentResponseGenerator (reference:
    # StreamingResponse over uvicorn).
    stream: bool = False

    def options(self, **overrides) -> "Deployment":
        reject_num_tpus(overrides)
        return dataclasses.replace(self, **overrides)

    def bind(self, *init_args, **init_kwargs) -> "Application":
        return Application(self, init_args, init_kwargs)


class Application:
    """A bound deployment graph node (reference: `serve/_private/build_app`).

    Binding another Application as an init arg expresses composition: the
    inner deployment is deployed too and the outer replica receives a
    DeploymentHandle in its place.
    """

    def __init__(self, deployment: Deployment, init_args: tuple,
                 init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs

    def _collect(self, app_name: str, out: List[Dict[str, Any]],
                 is_ingress: bool) -> DeploymentHandle:
        args = tuple(
            a._collect(app_name, out, False) if isinstance(a, Application)
            else a for a in self.init_args)
        kwargs = {
            k: (v._collect(app_name, out, False)
                if isinstance(v, Application) else v)
            for k, v in self.init_kwargs.items()
        }
        d = self.deployment
        from ray_tpu_torch.serve._private.autoscale import (
            AUTOSCALING_DEFAULTS, validate_autoscaling_config)

        autoscaling = d.autoscaling_config
        num_replicas = d.num_replicas
        if num_replicas == "auto":
            # "auto" routes through the controller's AutoscalePolicy:
            # the deployment *starts* at min_replicas but scales between
            # min/max on the metrics plane (it used to pin to min and
            # never move when no autoscaling_config was given).
            autoscaling = dict(autoscaling or {})
            autoscaling.setdefault("mode", "metrics")
        if autoscaling is not None:
            autoscaling = {**AUTOSCALING_DEFAULTS, **autoscaling}
            validate_autoscaling_config(autoscaling)
        if num_replicas == "auto":
            num_replicas = autoscaling["min_replicas"]
        if not any(spec["name"] == d.name for spec in out):
            out.append({
                "name": d.name,
                "serialized_callable": cloudpickle.dumps(d.func_or_class),
                "init_args": args,
                "init_kwargs": kwargs,
                "num_replicas": num_replicas,
                "num_cpus": d.num_cpus,
                "num_gpus": d.num_gpus,
                "route_prefix": d.route_prefix,
                "is_ingress": is_ingress,
                "max_ongoing_requests": d.max_ongoing_requests,
                "autoscaling_config": autoscaling,
                "stream": d.stream,
                # @serve.ingress(app)-wrapped classes: the proxy forwards
                # the raw HTTP request and writes back status/headers/body.
                "asgi": bool(getattr(d.func_or_class, "_serve_is_asgi",
                                     False)),
            })
        return DeploymentHandle(app_name, d.name)


def deployment(func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Any = 1, num_cpus: float = 1,
               num_gpus: float = 0, route_prefix: Optional[str] = None,
               max_ongoing_requests: int = 8,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               stream: bool = False, **options):
    # The runtime's own guard, so that num_tpus raises the error a remote
    # raises; any other unknown option is a TypeError as a signature's.
    reject_num_tpus(options)
    if options:
        raise TypeError(f"deployment() got unexpected options "
                        f"{sorted(options)}")

    def wrap(target):
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas, num_cpus=num_cpus,
            num_gpus=num_gpus, route_prefix=route_prefix,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config, stream=stream)

    return wrap(func_or_class) if func_or_class is not None else wrap


# ---------------------------------------------------------------- lifecycle

def start(http_port: int = 0, proxy_location: str = "HeadOnly",
          http_host: Optional[str] = None):
    """Start the HTTP ingress (controller starts lazily on first run()).

    The proxy is an HTTP/1.1 server on ``asyncio`` streams from the
    standard library (``serve/_private/proxy.py``), so it needs no
    ``aiohttp``; it leases no GPU and never makes a CUDA context. Its
    wire behaviour is the reference's: ``/<app>`` calls the app's ingress
    with the decoded JSON body, ``/-/healthz`` and ``/-/routes`` answer.

    ``proxy_location="EveryNode"`` pins one proxy actor per alive node
    (reference: ProxyLocation.EveryNode — each node accepts traffic and
    routes to replicas anywhere), returning the head-node proxy.

    The proxy binds loopback by default (it has no authentication);
    EveryNode implies 0.0.0.0 because cross-node ingress is the point,
    and ``http_host`` overrides either way.
    """
    from ray_tpu_torch.serve._private.controller import (
        get_or_create_controller,
    )

    get_or_create_controller()
    from ray_tpu_torch.serve._private.proxy import ProxyActor

    if proxy_location == "EveryNode":
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        head = None
        for node in ray_tpu_torch.nodes():
            if not node.get("Alive"):
                continue
            node_id = node["NodeID"]
            name = f"{_PROXY_NAME}:{node_id[:12]}"
            try:
                proxy = ray_tpu_torch.get_actor(name)
            except Exception:
                proxy = ProxyActor.options(
                    name=name, lifetime="detached",
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=node_id, soft=False),
                ).remote(http_port, http_host or "0.0.0.0")
            if head is None:
                head = proxy
        return head
    try:
        return ray_tpu_torch.get_actor(_PROXY_NAME)
    except Exception:
        return ProxyActor.options(
            name=_PROXY_NAME, lifetime="detached",
        ).remote(http_port, http_host or "127.0.0.1")


_GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"


def start_grpc(grpc_port: int = 0, host: str = "127.0.0.1",
               grpc_servicer_functions=None):
    """Start the gRPC ingress (reference: grpc_options on serve.start →
    the gRPC proxy in `_private/proxy.py`). Shares the HTTP proxy's
    routing plane; see `serve/_private/grpc_proxy.py` for the wire
    contract. It needs ``grpcio``, imported in the proxy's process when
    its server starts (the card's machine has it), not at import.
    `grpc_servicer_functions`: generated ``add_XServicer_to_server``
    callables (or their dotted import paths — pass strings when the proxy
    actor may run in a process that must re-import them) whose rpc
    methods the proxy serves with the user's own proto (de)serializers."""
    from ray_tpu_torch.serve._private.controller import (
        get_or_create_controller,
    )
    from ray_tpu_torch.serve._private.grpc_proxy import (
        GrpcProxyActor, harvest_servicer_methods)

    get_or_create_controller()
    try:
        proxy = ray_tpu_torch.get_actor(_GRPC_PROXY_NAME)
    except Exception:
        proxy = None
    if proxy is not None:
        if grpc_servicer_functions:
            # A live proxy without the requested servicers would answer
            # every user-proto rpc UNIMPLEMENTED with no hint why —
            # recreate it (the proxy is stateless) instead of silently
            # dropping the argument.
            wanted = set(harvest_servicer_methods(grpc_servicer_functions))
            have = set(ray_tpu_torch.get(
                proxy.get_user_method_paths.remote(), timeout=30))
            if not wanted <= have:
                import time as _time

                ray_tpu_torch.kill(proxy)
                deadline = _time.monotonic() + 10
                while _time.monotonic() < deadline:
                    try:
                        ray_tpu_torch.get_actor(_GRPC_PROXY_NAME)
                        _time.sleep(0.1)   # name not released yet
                    except Exception:
                        break
                proxy = None
        if proxy is not None:
            return proxy
    return GrpcProxyActor.options(
        name=_GRPC_PROXY_NAME, lifetime="detached",
    ).remote(grpc_port, host,
             servicer_functions=grpc_servicer_functions)


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = None,
        _overrides: Optional[Dict[str, Dict[str, Any]]] = None
        ) -> DeploymentHandle:
    """Deploy (or redeploy) an application; returns its ingress handle.

    `_overrides` maps deployment name -> spec overrides; it is how
    declarative config deploys (`serve/schema.py`) re-tune a code-defined
    app without editing code (reference: config fields shadow @deployment
    options)."""
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    controller = get_or_create_controller()
    specs: List[Dict[str, Any]] = []
    handle = app._collect(name, specs, True)
    if route_prefix is not None:
        for spec in specs:
            if spec["is_ingress"]:
                spec["route_prefix"] = route_prefix
    if _overrides:
        unknown = set(_overrides) - {s["name"] for s in specs}
        if unknown:
            raise ValueError(
                f"config overrides reference deployment(s) "
                f"{sorted(unknown)} not present in app {name!r} "
                f"(has {sorted(s['name'] for s in specs)})")
        for spec in specs:
            ov = dict(_overrides.get(spec["name"], ()))
            if not ov:
                continue
            wants_auto = ov.get("num_replicas") == "auto"
            if wants_auto:
                ov.pop("num_replicas")
            if wants_auto or "autoscaling_config" in ov:
                # Same defaults merge _collect applies to code-defined
                # configs — a partial config dict must never reach the
                # controller (reconcile KeyErrors on missing knobs).
                from ray_tpu_torch.serve._private.autoscale import (
                    AUTOSCALING_DEFAULTS, validate_autoscaling_config)

                auto = {
                    **AUTOSCALING_DEFAULTS,
                    **(spec.get("autoscaling_config") or {}),
                    **(ov.get("autoscaling_config") or {}),
                }
                if wants_auto:
                    auto.setdefault("mode", "metrics")
                validate_autoscaling_config(auto)
                ov["autoscaling_config"] = auto
                if wants_auto:
                    ov["num_replicas"] = auto["min_replicas"]
            spec.update(ov)
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs),
                timeout=120)
    return handle


def get_app_handle(name: str = "default") -> DeploymentHandle:
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    controller = get_or_create_controller()
    ingress = ray_tpu_torch.get(controller.get_ingress.remote(name), timeout=30)
    if ingress is None:
        raise KeyError(f"no application '{name}'")
    return DeploymentHandle(name, ingress)


def status(name: str = "default") -> List[Dict[str, Any]]:
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    return ray_tpu_torch.get(
        get_or_create_controller().list_deployments.remote(name), timeout=30)


def list_applications() -> List[str]:
    """Names of deployed applications; [] when serve was never started
    (read-only: does NOT spawn a controller)."""
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return []
    return ray_tpu_torch.get(controller.list_applications.remote(), timeout=30)


def delete(name: str) -> None:
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    ray_tpu_torch.get(get_or_create_controller().delete_application.remote(name),
                timeout=60)


def shutdown(graceful_timeout_s: float = 20.0) -> None:
    """Tear serve down, bounded end to end.

    Graceful first (controller drains replicas), then ``ray_tpu_torch.kill``,
    then — if a serve system actor's worker process is STILL alive past
    the deadline — SIGKILL it directly. A wedged controller/proxy must
    never hang the caller: one stuck teardown used to cascade into
    setup timeouts for every test that followed (reference discipline:
    `serve/_private/controller.py` graceful_shutdown + fixture kills in
    `python/ray/tests/conftest.py`)."""
    import os
    import signal
    import time as _time

    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    names = (_PROXY_NAME, _GRPC_PROXY_NAME, CONTROLLER_NAME)
    deadline = _time.monotonic() + graceful_timeout_s

    # Snapshot the system actors' worker pids BEFORE killing, for the
    # hard backstop below.
    pids = []
    try:
        from ray_tpu_torch.util import state as _state

        workers = {w["worker_id"]: w.get("pid")
                   for w in _state.list_workers()}
        for a in _state.list_actors():
            if a.get("name") in names and a.get("state") != "DEAD":
                pid = workers.get(a.get("worker_id"))
                if pid:
                    pids.append(int(pid))
    except Exception:
        pass

    for actor_name in names:
        try:
            actor = ray_tpu_torch.get_actor(actor_name)
        except Exception:
            continue
        if actor_name == CONTROLLER_NAME:
            try:
                ray_tpu_torch.get(actor.graceful_shutdown.remote(),
                            timeout=max(2.0, deadline - _time.monotonic()))
            except Exception:
                pass
        try:
            ray_tpu_torch.kill(actor)
        except Exception:
            pass

    # Hard backstop: wait briefly for the processes to die, then SIGKILL
    # survivors. os.kill only reaches same-host pids, which is exactly
    # the wedge this guards (test clusters are single-host; multi-node
    # kills already went through the raylet above).
    kill_deadline = _time.monotonic() + 5.0
    for pid in pids:
        while _time.monotonic() < kill_deadline:
            try:
                os.kill(pid, 0)
            except OSError:
                break  # gone
            _time.sleep(0.1)
        else:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
