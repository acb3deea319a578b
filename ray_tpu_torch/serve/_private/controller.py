"""ServeController — the serving control plane, as a singleton actor:
the port's copy of ``ray_tpu/serve/_private/controller.py``.

Reference: `serve/_private/controller.py:84` (deploy_application at
`:700`) + `deployment_state.py:1229`: the controller holds the goal state
(deployment specs) and a reconcile loop converges actual replica actors to
it — scaling up/down, replacing crashed replicas, and bumping a routing
version so handles/proxies refresh their replica sets. A replica's share
of the card is its spec's ``num_gpus`` (the reference's ``num_tpus``); the
controller itself leases no GPU and never makes a CUDA context.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

CONTROLLER_NAME = "SERVE_CONTROLLER"


@ray_tpu_torch.remote(num_cpus=0.5, max_concurrency=32)
class ServeController:
    def __init__(self):
        from ray_tpu_torch.serve._private.replica import Replica

        self._replica_cls = Replica
        # app -> deployment name -> spec dict
        self._apps: Dict[str, Dict[str, Dict[str, Any]]] = {}
        # (app, deployment) -> list of replica handles
        self._replicas: Dict[tuple, List[Any]] = {}
        # (app, deployment) -> router_id -> (inflight, ts): handle-side
        # load reports driving the autoscaler.
        self._handle_metrics: Dict[tuple, Dict[str, tuple]] = {}
        # (app, deployment) -> AutoscalePolicy (hysteresis + cooldown
        # state lives inside; rebuilt when the config changes).
        self._policies: Dict[tuple, Any] = {}
        self._policy_cfgs: Dict[tuple, Any] = {}
        # (app, deployment) -> the metric reading behind the latest
        # desired-replica verdict (attached to scale decisions/events).
        self._last_reading: Dict[tuple, Dict[str, Any]] = {}
        # MetricsHub over the serve_* gauges, refreshed by the
        # bounded-period autoscale policy loop (None until first fetch).
        self._hub = None
        # (app, deployment) -> hash of the spec its replicas were built
        # from; a mismatch triggers a rolling replacement.
        self._replica_hash: Dict[tuple, str] = {}
        self._version = 0
        self._lock = threading.Lock()
        # Long-pollers park on this until the routing version bumps
        # (reference: serve LongPollHost — push-invalidated routers).
        self._version_cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        threading.Thread(target=self._reconcile_loop, daemon=True,
                         name="serve-reconcile").start()
        threading.Thread(target=self._autoscale_policy_loop, daemon=True,
                         name="serve-autoscale-policy").start()

    # ------------------------------------------------------------- deploy
    def deploy_application(self, app_name: str,
                           deployments: List[Dict[str, Any]]) -> bool:
        with self._lock:
            self._apps[app_name] = {d["name"]: d for d in deployments}
        self._reconcile_once()
        return True

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            deployments = self._apps.pop(app_name, {})
            for name in deployments:
                for replica in self._replicas.pop((app_name, name), []):
                    try:
                        ray_tpu_torch.kill(replica)
                    except Exception:
                        pass
                self._handle_metrics.pop((app_name, name), None)
                self._policies.pop((app_name, name), None)
                self._policy_cfgs.pop((app_name, name), None)
                self._last_reading.pop((app_name, name), None)
            self._version += 1
            self._version_cond.notify_all()
        return True

    # ---------------------------------------------------------- reconcile
    def _reconcile_loop(self):
        while not self._stop.is_set():
            try:
                self._reconcile_once()
            except Exception:
                pass
            self._stop.wait(1.0)

    def _reconcile_once(self):
        with self._lock:
            goal = [(app, dict(spec))
                    for app, deps in self._apps.items()
                    for spec in deps.values()]
        changed = False
        for app, spec in goal:
            key = (app, spec["name"])
            spec_hash = self._spec_hash(spec)
            # This method runs on the reconcile thread while RPC threads
            # read and delete the same maps under self._lock, so every
            # touch of shared state below happens under the lock too; the
            # slow work (health probes, spawns, drains) runs outside it
            # on local snapshots.
            with self._lock:
                if spec["name"] not in self._apps.get(app, {}):
                    continue  # deleted since the goal snapshot
                replicas = self._replicas.setdefault(key, [])
                # Rolling code update (reference: deployment_state version
                # rollout): a redeploy with different code/config retires
                # every replica built from the old spec — matching replica
                # count alone would keep serving stale code.
                retiring = []
                if replicas and self._replica_hash.get(key) != spec_hash:
                    # Old-spec replicas keep serving until the new ones
                    # exist; they drain only after the spawn loop below
                    # has refilled the replica set (no empty-routing
                    # window on redeploy).
                    retiring = list(replicas)
                    replicas.clear()
                    changed = True
                self._replica_hash[key] = spec_hash
                probe = list(replicas)
            # Drop dead replicas (health probe).
            live = []
            for r in probe:
                try:
                    ray_tpu_torch.get(r.check_health.remote(), timeout=30)
                    live.append(r)
                except Exception:
                    changed = True
            want = self._desired_replicas(key, spec, len(live))
            if spec.get("autoscaling_config") and len(live) > 0 \
                    and want != len(live):
                self._record_scale_decision(key, len(live), want)
            spawned = []
            while len(live) + len(spawned) < want:
                options: Dict[str, Any] = dict(
                    num_cpus=spec.get("num_cpus", 1),
                    max_concurrency=spec.get("max_ongoing_requests", 8))
                if spec.get("num_gpus"):
                    options["num_gpus"] = spec["num_gpus"]
                spawned.append(self._replica_cls.options(**options).remote(
                    spec["name"], spec["serialized_callable"],
                    tuple(spec.get("init_args", ())),
                    dict(spec.get("init_kwargs", {}))))
                changed = True
            with self._lock:
                if self._replicas.get(key) is not replicas:
                    # delete_application() removed this deployment while
                    # we were probing/spawning. Nothing may be
                    # resurrected: the survivors were already killed by
                    # the delete, the fresh spawns were never routed —
                    # tear them all down and walk away.
                    retiring, doomed_list, count = [], live + spawned, None
                else:
                    replicas[:] = live + spawned
                    # Remove downscaled replicas from routing first, then
                    # drain before killing — autoscaling makes downscale
                    # routine; in-flight requests must finish (reference:
                    # graceful replica shutdown).
                    doomed_list = replicas[want:]
                    del replicas[want:]
                    if doomed_list:
                        changed = True
                    if retiring or doomed_list:
                        self._version += 1
                        self._version_cond.notify_all()
                    count = len(replicas)
            for doomed in retiring:
                self._drain_and_kill(doomed)
            for doomed in doomed_list:
                self._drain_and_kill(doomed)
            if count is None:
                continue
            try:
                from ray_tpu_torch.observability.serve import serve_metrics
                serve_metrics().replicas.set(
                    count,
                    tags={"deployment": f"{app}/{spec['name']}"})
            except Exception:
                pass
        if changed:
            with self._lock:
                self._version += 1
                self._version_cond.notify_all()

    @staticmethod
    def _spec_hash(spec: Dict[str, Any]) -> str:
        import hashlib

        import cloudpickle

        h = hashlib.md5()
        h.update(spec.get("serialized_callable", b""))
        # cloudpickle (not repr): init args may hold DeploymentHandles,
        # whose default repr embeds a memory address — the hash must be
        # stable across identical redeploys.
        h.update(cloudpickle.dumps((spec.get("init_args"),
                                    spec.get("init_kwargs"))))
        for field in ("num_cpus", "num_gpus", "max_ongoing_requests",
                      "stream"):
            h.update(repr(spec.get(field)).encode())
        return h.hexdigest()

    def _drain_and_kill(self, replica, timeout_s: float = 10.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                stats = ray_tpu_torch.get(replica.stats.remote(), timeout=10)
                if stats.get("ongoing", 0) == 0:
                    break
            except Exception:
                break
            time.sleep(0.25)
        try:
            ray_tpu_torch.get(replica.prepare_shutdown.remote(), timeout=5)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    # --------------------------------------------------------- autoscaling
    def record_handle_metrics(self, app_name: str, deployment_name: str,
                              router_id: str, inflight: int) -> bool:
        """Handle-side ongoing-request report (reference: handles push
        metrics the controller's autoscaler aggregates)."""
        key = (app_name, deployment_name)
        with self._lock:
            self._handle_metrics.setdefault(key, {})[router_id] = (
                inflight, time.monotonic())
        return True

    def _total_inflight(self, key: tuple) -> int:
        now = time.monotonic()
        with self._lock:
            reports = self._handle_metrics.get(key, {})
            # Routers report every ~2s; prune dead routers' entries so a
            # long-lived controller doesn't accumulate them forever.
            for rid, (_, ts) in list(reports.items()):
                if now - ts >= 10.0:
                    del reports[rid]
            return sum(v for v, _ in reports.values())

    def _desired_replicas(self, key: tuple, spec: Dict[str, Any],
                          current: int) -> int:
        # Defaults live in api.py's spec build (single source of truth);
        # specs arriving here always carry the full config.
        cfg = spec.get("autoscaling_config")
        if not cfg:
            return spec.get("num_replicas", 1)
        from ray_tpu_torch.serve._private.autoscale import AutoscalePolicy

        # The policy maps are shared with delete_application() on the RPC
        # threads; mutate them only under the lock. policy.desired() runs
        # outside it (_total_inflight re-acquires, and the lock must stay
        # cheap for the long-pollers parked on its condition).
        with self._lock:
            policy = self._policies.get(key)
            if policy is None or self._policy_cfgs.get(key) != cfg:
                policy = AutoscalePolicy(cfg)
                self._policies[key] = policy
                self._policy_cfgs[key] = dict(cfg)
        want, reading = policy.desired(
            current, self._total_inflight(key), hub=self._hub)
        with self._lock:
            self._last_reading[key] = reading
        return want

    def _autoscale_policy_loop(self):
        """Bounded-period metrics side of the autoscaler: refresh the
        MetricsHub view of the serve_* gauges that `_desired_replicas`
        reads on the next reconcile tick. Jittered so a fleet of
        controllers never thunders the GCS in phase; separate from the
        reconcile loop so a slow GCS fetch cannot stall replica health
        probes."""
        import random

        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch.util.metrics import MetricsHub

        while not self._stop.is_set():
            period = max(0.25, GlobalConfig.serve_autoscale_interval_s)
            self._stop.wait(period * random.uniform(0.8, 1.2))
            if self._stop.is_set():
                return
            try:
                if self._hub is None:
                    self._hub = MetricsHub()
                self._hub.refresh(prefixes=["serve_"], force=True)
            except Exception:
                pass

    def _record_scale_decision(self, key: tuple, current: int,
                               want: int) -> None:
        """Every granted scale action is observable: decision counter,
        timeline span, typed cluster event with the triggering reading,
        and the GCS decision ring (GET /api/controller)."""
        from ray_tpu_torch.observability.control import record_decision

        app, name = key
        with self._lock:
            reading = dict(self._last_reading.get(key, {}))
        reading.update({"app": app, "deployment": name,
                        "from": current, "to": want})
        message = (f"{app}/{name}: {current} -> {want} replicas "
                   f"(inflight={reading.get('inflight')}, "
                   f"queue_wait_p95_s={reading.get('queue_wait_p95_s')}, "
                   f"slot_utilization={reading.get('slot_utilization')})")
        try:
            if want > current:
                record_decision(
                    "serve_autoscaler", "scale_up", "load above target",
                    reading, event_type="AUTOSCALE_UP", message=message)
            else:
                record_decision(
                    "serve_autoscaler", "scale_down", "load below target",
                    reading, event_type="AUTOSCALE_DOWN", message=message)
        except Exception:
            pass

    # -------------------------------------------------------------- query
    def get_replicas(self, app_name: str, deployment_name: str):
        """Returns (version, [replica handles]) for router refresh."""
        with self._lock:
            return self._version, list(
                self._replicas.get((app_name, deployment_name), []))

    def routing_version(self) -> int:
        with self._lock:
            return self._version

    def poll_replicas(self, app_name: str, deployment_name: str,
                      known_version: int = -1, timeout_s: float = 25.0):
        """Long-poll get_replicas: replies immediately when the routing
        version moved past `known_version`, else parks until a bump or the
        window closes (reference: `long_poll.py` LongPollHost.listen)."""
        deadline = time.time() + timeout_s
        with self._version_cond:
            while self._version == known_version:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._version_cond.wait(min(1.0, remaining))
            return self._version, list(
                self._replicas.get((app_name, deployment_name), []))

    def poll_routes(self, known_version: int = -1,
                    timeout_s: float = 25.0):
        """Long-poll the route table: app name -> ingress deployment."""
        deadline = time.time() + timeout_s
        with self._version_cond:
            while self._version == known_version:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._version_cond.wait(min(1.0, remaining))
            routes = {}
            for app, deployments in self._apps.items():
                for name, spec in deployments.items():
                    if spec.get("is_ingress"):
                        routes[app] = {
                            "deployment": name,
                            "route_prefix": spec.get("route_prefix")
                            or f"/{app}",
                            "stream": bool(spec.get("stream")),
                            "asgi": bool(spec.get("asgi")),
                        }
            return self._version, routes

    def list_deployments(self, app_name: str) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for name, spec in self._apps.get(app_name, {}).items():
                out.append({
                    "name": name,
                    "num_replicas": spec.get("num_replicas", 1),
                    "live_replicas": len(
                        self._replicas.get((app_name, name), [])),
                    "route_prefix": spec.get("route_prefix"),
                    "is_ingress": spec.get("is_ingress", False),
                })
            return out

    def list_applications(self) -> List[str]:
        with self._lock:
            return list(self._apps)

    def get_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            for name, spec in self._apps.get(app_name, {}).items():
                if spec.get("is_ingress"):
                    return name
        return None

    def graceful_shutdown(self) -> bool:
        self._stop.set()
        with self._lock:
            doomed = [r for replicas in self._replicas.values()
                      for r in replicas]
            self._replicas.clear()
            self._apps.clear()
            # Wake parked long-pollers so they observe the empty tables
            # now instead of sleeping out their window.
            self._version += 1
            self._version_cond.notify_all()
        for r in doomed:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        return True


def get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        pass
    try:
        return ServeController.options(
            name=CONTROLLER_NAME, lifetime="detached").remote()
    except Exception:
        # Raced with another creator.
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
