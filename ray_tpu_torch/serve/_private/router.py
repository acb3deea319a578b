"""Router — picks a replica for each request: the port's copy of
``ray_tpu/serve/_private/router.py``.

Reference: `serve/_private/router.py:254` + power-of-two-choices scheduler
(`replica_scheduler/pow_2_scheduler.py:44`): sample two random replicas,
send to the one with fewer locally-tracked in-flight requests. The replica
set is push-invalidated: a background thread long-polls the controller
(`poll_replicas`, the LongPollHost analogue) and replies arrive the moment
the routing version bumps — the request hot path never talks to the
controller.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List

import ray_tpu_torch


class Router:
    def __init__(self, controller, app_name: str, deployment_name: str):
        import uuid

        self._controller = controller
        self._app = app_name
        self._deployment = deployment_name
        self._replicas: List[Any] = []
        self._version = -1
        self._inflight: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._have_replicas = threading.Event()
        self._router_id = uuid.uuid4().hex[:12]
        self._push_thread_started = False
        self._closed = False
        # The worker this router was born under: background threads must
        # die with it. Without this, every serve handle ever created
        # leaked a forever-polling daemon thread that kept hammering a
        # dead controller (and the ref-counter lock) for the rest of the
        # PROCESS — dozens of zombie pollers ground long test sessions
        # to a halt two modules later.
        from ray_tpu_torch._private.worker import global_worker_or_none

        self._worker = global_worker_or_none()
        # Synchronous first snapshot, then the long-poll keeps it fresh.
        self._apply(*ray_tpu_torch.get(
            self._controller.get_replicas.remote(app_name, deployment_name),
            timeout=60))
        threading.Thread(target=self._poll_loop, daemon=True,
                         name="serve-router-poll").start()

    def _apply(self, version: int, replicas: List[Any]) -> None:
        with self._lock:
            if version != self._version:
                self._version = version
                self._replicas = replicas
                self._inflight = {r: self._inflight.get(r, 0)
                                  for r in replicas}
            if self._replicas:
                self._have_replicas.set()
            else:
                self._have_replicas.clear()

    def _alive(self) -> bool:
        from ray_tpu_torch._private.worker import global_worker_or_none

        w = global_worker_or_none()
        return (not self._closed and w is not None and w is self._worker
                and not getattr(w, "_dead", False))

    def _poll_loop(self) -> None:
        while self._alive():
            try:
                version, replicas = ray_tpu_torch.get(
                    self._controller.poll_replicas.remote(
                        self._app, self._deployment, self._version, 25.0),
                    timeout=60)
                self._apply(version, replicas)
            except Exception:
                if not self._alive():
                    return
                time.sleep(1.0)

    def _maybe_push_metrics(self) -> None:
        """Start the periodic load reporter on first traffic. A background
        thread (not push-on-assign) keeps reports fresh while long
        requests run with no new arrivals — otherwise the controller sees
        stale-then-zero load and downscales mid-traffic."""
        with self._lock:
            if self._push_thread_started:
                return
            self._push_thread_started = True

        def run():
            while self._alive():
                time.sleep(2.0)
                with self._lock:
                    total = sum(self._inflight.values())
                try:
                    self._controller.record_handle_metrics.remote(
                        self._app, self._deployment, self._router_id, total)
                except Exception:
                    return    # cluster gone; let the thread die

        threading.Thread(target=run, daemon=True,
                         name="serve-metrics-push").start()

    def close(self) -> None:
        """Stop the background threads; the router routes no further
        requests. Safe to call more than once."""
        self._closed = True

    def assign_request(self, method_name: str, args: tuple, kwargs: dict,
                       model_id: str = "", stream: bool = False):
        """Returns an ObjectRef (or ObjectRefGenerator when streaming)."""
        if not self._alive():
            # A handle that outlived its worker would otherwise route on
            # a frozen replica snapshot from the dead cluster.
            raise RuntimeError(
                f"router for {self._app}/{self._deployment} is detached "
                "(its cluster connection was shut down); recreate the "
                "handle after ray_tpu_torch.init()")
        if not self._have_replicas.wait(timeout=30.0):
            raise RuntimeError(
                f"no live replicas for {self._app}/{self._deployment}")
        with self._lock:
            replicas = list(self._replicas)
            if not replicas:
                raise RuntimeError(
                    f"no live replicas for {self._app}/{self._deployment}")
            if len(replicas) == 1:
                chosen = replicas[0]
            elif model_id:
                # Cache affinity: one stable replica per model id so its
                # weights load once, not on every replica (reference:
                # multiplexed routing).
                from ray_tpu_torch.serve.multiplex import rendezvous_pick

                chosen = rendezvous_pick(
                    sorted(replicas, key=lambda r: r._actor_id),
                    model_id)
            else:
                a, b = random.sample(replicas, 2)
                chosen = (a if self._inflight.get(a, 0)
                          <= self._inflight.get(b, 0) else b)
            self._inflight[chosen] = self._inflight.get(chosen, 0) + 1
        self._maybe_push_metrics()

        method = chosen.handle_request
        if stream:
            method = method.options(num_returns="streaming")
        ref = method.remote(method_name, args, kwargs, model_id)

        def _done(_fut):
            with self._lock:
                if chosen in self._inflight:
                    self._inflight[chosen] -= 1

        if stream:
            # Generator: decrement when the final item lands (the
            # generator ref resolves at completion).
            ref._ref0.future().add_done_callback(_done)
        else:
            ref.future().add_done_callback(_done)
        return ref
