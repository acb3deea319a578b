"""Workflow event system — durable external triggers.

Reference: `python/ray/workflow/event_listener.py:1` (EventListener ABC:
``poll_for_event`` + the post-checkpoint ``event_checkpointed`` ack) and
`python/ray/workflow/http_event_provider.py:1` (an HTTP endpoint
external systems POST events to; workflows park on them).

Redesign over this package's storage model: a delivered event is a FILE
in the workflow's storage directory (written atomically), so event
durability needs no extra service state —

* `wait_for_event(listener)` makes a DAG node that completes when the
  listener's poll returns. The payload checkpoints like any step
  output: a workflow that crashes AFTER delivery replays it from
  storage on resume (never re-waits); a crash BEFORE delivery resumes
  into the same poll. `event_checkpointed` fires only after the
  checkpoint is on disk — the at-least-once ack point for the external
  system.
* `HTTPEventProvider` exposes POST /event/{workflow_id}/{key} (body =
  JSON payload); it writes the event file the default
  `FileEventListener` polls. GET on the same path reads it back
  (delivery check for the poster).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional

__all__ = ["EventListener", "FileEventListener", "HTTPEventProvider",
           "wait_for_event"]


class EventListener:
    """One external-event source (reference: event_listener.py ABC)."""

    def bind(self, workflow_id: str, storage_dir: str) -> None:
        """Called by the executor before polling: runtime identity."""

    def poll_for_event(self, timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def event_checkpointed(self, event: Any) -> None:
        """Post-checkpoint ack: the event is durable; the source may
        delete/commit it."""


def _event_path(storage_dir: str, workflow_id: str, key: str) -> str:
    return os.path.join(storage_dir, workflow_id, "events", f"{key}.json")


class FileEventListener(EventListener):
    """Polls the storage-backed event file the HTTP provider (or any
    writer) delivers. The default listener."""

    def __init__(self, event_key: str, poll_interval_s: float = 0.2):
        self.event_key = event_key
        self._poll = poll_interval_s
        self._wf_id: Optional[str] = None
        self._storage: Optional[str] = None

    def bind(self, workflow_id: str, storage_dir: str) -> None:
        self._wf_id = workflow_id
        self._storage = storage_dir

    def _path(self) -> str:
        if self._wf_id is None:
            raise RuntimeError("listener not bound to a workflow")
        return _event_path(self._storage, self._wf_id, self.event_key)

    def poll_for_event(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        path = self._path()
        while True:
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no '{self.event_key}' event for workflow "
                    f"'{self._wf_id}' within {timeout}s")
            time.sleep(self._poll)


def deliver_event(storage_dir: str, workflow_id: str, key: str,
                  payload: Any) -> str:
    """Write an event file atomically (what the HTTP provider does; also
    usable directly by co-located systems/tests)."""
    path = _event_path(storage_dir, workflow_id, key)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)
    return path


class HTTPEventProvider:
    """POST /event/{workflow_id}/{key} -> durable event file.

    Reference: `workflow/http_event_provider.py` (a Serve deployment
    there; a plain aiohttp app here — it only needs to turn an HTTP
    request into one atomic file write)."""

    def __init__(self, storage_dir: str, host: str = "127.0.0.1",
                 port: int = 0):
        self._storage = storage_dir
        self._host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self._runner = None
        self._thread = None

    def start(self) -> "HTTPEventProvider":
        import asyncio
        import threading

        from aiohttp import web

        async def post_event(req):
            wf, key = req.match_info["wf"], req.match_info["key"]
            try:
                payload = await req.json()
            except Exception:
                payload = (await req.read()).decode("utf-8", "replace")
            path = await asyncio.get_running_loop().run_in_executor(
                None, deliver_event, self._storage, wf, key, payload)
            return web.json_response({"delivered": True, "path": path})

        async def get_event(req):
            path = _event_path(self._storage, req.match_info["wf"],
                               req.match_info["key"])
            if not os.path.exists(path):
                return web.json_response({"delivered": False}, status=404)

            def _read():
                with open(path) as f:
                    return json.load(f)

            payload = await asyncio.get_running_loop().run_in_executor(
                None, _read)
            return web.json_response({"delivered": True,
                                      "payload": payload})

        app = web.Application()
        app.router.add_post("/event/{wf}/{key}", post_event)
        app.router.add_get("/event/{wf}/{key}", get_event)

        loop = asyncio.new_event_loop()
        started = threading.Event()

        def _run():
            asyncio.set_event_loop(loop)

            async def _up():
                self._runner = web.AppRunner(app)
                await self._runner.setup()
                site = web.TCPSite(self._runner, self._host,
                                   self._requested_port)
                await site.start()
                self.port = site._server.sockets[0].getsockname()[1]
                started.set()

            loop.run_until_complete(_up())
            loop.run_forever()

        self._loop = loop
        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="wf-event-provider")
        self._thread.start()
        if not started.wait(timeout=10):
            raise RuntimeError("event provider failed to start")
        return self

    def stop(self) -> None:
        import asyncio

        if self._thread is None:
            return

        async def _down():
            if self._runner is not None:
                await self._runner.cleanup()
            self._loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(_down(), self._loop)
            self._thread.join(timeout=5)
        except Exception:
            pass


def wait_for_event(listener, *, timeout: Optional[float] = None,
                   name: str = "wait_for_event"):
    """DAG node that parks until the listener's event arrives
    (reference: `workflow.wait_for_event`). `listener`: an EventListener
    instance, a zero-arg factory, or an event-key string (shorthand for
    the default FileEventListener)."""
    from ray_tpu_torch.workflow import EventStep

    if isinstance(listener, str):
        listener = FileEventListener(listener)
    elif callable(listener) and not isinstance(listener, EventListener):
        listener = listener()
    return EventStep(listener, timeout=timeout, name=name)
