"""Shared proxy routing plane (HTTP + gRPC ingress): the port's copy of
``ray_tpu/serve/_private/route_plane.py``.

One implementation of the push-invalidated route table: long-poll the
controller for route versions, cache per-app DeploymentHandles, evict
stale handles on redeploy (reference: the route table both proxy flavors
share in `serve/_private/proxy.py`)."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import ray_tpu_torch


class RoutePlane:
    """Mixin for proxy actors. Call ``_init_route_plane(controller)``
    from __init__ after the serving thread is up."""

    def _pre_init_route_plane(self) -> None:
        """Call BEFORE the serving thread starts: requests that land in
        the window before _init_route_plane see empty-but-valid state
        (404s) instead of AttributeErrors."""
        self._handles: Dict[str, Any] = {}
        self._routes: Dict[str, Dict[str, Any]] = {}
        self._routes_version = -1
        self._routes_ready = threading.Event()

    def _init_route_plane(self, controller) -> None:
        if not hasattr(self, "_routes"):
            self._pre_init_route_plane()
        self._controller = controller
        threading.Thread(target=self._route_poll_loop, daemon=True,
                         name="serve-proxy-routes").start()
        # First snapshot so early requests route.
        try:
            version, routes = ray_tpu_torch.get(
                self._controller.poll_routes.remote(-1, 0.1), timeout=30)
            self._routes_version, self._routes = version, routes
        except Exception:
            pass
        self._routes_ready.set()

    def _route_poll_loop(self) -> None:
        while True:
            try:
                version, routes = ray_tpu_torch.get(
                    self._controller.poll_routes.remote(
                        self._routes_version, 25.0), timeout=60)
                self._routes_version = version
                self._routes = routes
                for app in set(self._handles) - set(routes):
                    self._handles.pop(app, None)
            except Exception:
                time.sleep(1.0)

    def _handle_for(self, app: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        route = self._routes.get(app)
        if route is None:
            raise KeyError(f"no application '{app}'")
        cached = self._handles.get(app)
        if cached is not None and cached[0] == route["deployment"]:
            return cached[1]
        # First request, or the ingress deployment was renamed by a
        # redeploy — a stale handle would route to the retired name.
        handle = DeploymentHandle(app, route["deployment"])
        self._handles[app] = (route["deployment"], handle)
        return handle

    def _lookup_handle(self, app: str, wait_s: float = 0.0):
        """Handle for `app`, or None. ``wait_s`` bounds a retry for the
        short deploy-to-first-poll race; 0 matches the HTTP proxy's
        immediate-404 behavior."""
        self._routes_ready.wait(timeout=10)
        deadline = time.monotonic() + wait_s
        while True:
            try:
                return self._handle_for(app)
            except KeyError:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.1)
