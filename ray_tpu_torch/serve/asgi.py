"""ASGI integration for serve — FastAPI-style apps as ingress deployments:
the port's copy of ``ray_tpu/serve/asgi.py``.

Reference: `serve/_private/http_util.py` (ASGIAppReplicaWrapper wraps a
FastAPI/Starlette app inside a replica; the proxy forwards raw HTTP
scope). Re-designed here without a framework dependency:

* ``App`` is a tiny real ASGI application — decorator routing with
  ``{param}`` path templates, query/body parsing, JSON responses. Any
  genuine ASGI app (FastAPI, Starlette) plugs into the same wrapper,
  since the contract is plain ``(scope, receive, send)``.
* ``@serve.ingress(app)`` attaches the ASGI app to a deployment class:
  the proxy forwards the request (method/path/headers/query/body) to the
  replica, which drives the app on a private event loop and returns
  status/headers/body for the proxy to write through.
"""

from __future__ import annotations

import asyncio
import json
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["App", "Request", "Response", "ingress", "run_asgi_request"]


class Request:
    """Handler-facing request view (subset of the usual ASGI toolkits)."""

    def __init__(self, scope: dict, body: bytes):
        self.scope = scope
        self.method: str = scope.get("method", "GET")
        self.path: str = scope.get("path", "/")
        self.path_params: Dict[str, str] = scope.get("path_params", {})
        # Full fidelity list (duplicates preserved) + a convenience dict
        # that joins duplicates per RFC 9110 ("," separated).
        self.header_list: List[Tuple[str, str]] = [
            (k.decode() if isinstance(k, bytes) else k,
             v.decode() if isinstance(v, bytes) else v)
            for k, v in scope.get("headers", [])]
        self.headers = {}
        for k, v in self.header_list:
            self.headers[k] = f"{self.headers[k]}, {v}" \
                if k in self.headers else v
        qs = scope.get("query_string", b"")
        if isinstance(qs, str):
            qs = qs.encode()
        # parse_qsl percent-decodes and handles '+' (a hand-split would
        # pass values through still encoded).
        from urllib.parse import parse_qsl

        self.query_params_list: List[Tuple[str, str]] = parse_qsl(
            qs.decode(), keep_blank_values=True)
        self.query_params: Dict[str, str] = dict(self.query_params_list)
        self._body = body

    def body(self) -> bytes:
        return self._body

    def json(self) -> Any:
        return json.loads(self._body or b"null")


class Response:
    def __init__(self, content: Any = b"", status: int = 200,
                 headers=None, media_type: Optional[str] = None):
        if isinstance(content, bytes):
            body = content
            media_type = media_type or "application/octet-stream"
        elif isinstance(content, str):
            body = content.encode()
            media_type = media_type or "text/plain; charset=utf-8"
        else:
            body = json.dumps(content).encode()
            media_type = media_type or "application/json"
        self.body = body
        self.status = status
        # ``headers`` may be any mapping or a list of pairs (the latter
        # emits duplicates, e.g. multiple Set-Cookie).
        pairs = (list(headers.items()) if hasattr(headers, "items")
                 else list(headers or []))
        if not any(k.lower() == "content-type" for k, _ in pairs):
            pairs.append(("content-type", media_type))
        self.header_list: List[Tuple[str, str]] = pairs
        self.headers: Dict[str, str] = dict(pairs)


_PARAM = re.compile(r"{([a-zA-Z_][a-zA-Z0-9_]*)}")


class App:
    """Minimal ASGI application with FastAPI-style decorator routing."""

    def __init__(self):
        # (method, regex, param names, handler)
        self._routes: List[Tuple[str, "re.Pattern", List[str], Callable]] = []

    def route(self, path: str, methods=("GET",)):
        names = _PARAM.findall(path)
        # Escape the literal segments; only {param} placeholders become
        # groups (a '.' or '+' in a route must match itself, not regex).
        src = path.rstrip("/") or "/"
        parts = []
        last = 0
        for m in _PARAM.finditer(src):
            parts.append(re.escape(src[last:m.start()]))
            parts.append(f"(?P<{m.group(1)}>[^/]+)")
            last = m.end()
        parts.append(re.escape(src[last:]))
        pattern = re.compile("^" + "".join(parts) + "/?$")

        def decorator(fn):
            for m in methods:
                self._routes.append((m.upper(), pattern, names, fn))
            return fn
        return decorator

    def get(self, path: str):
        return self.route(path, ("GET",))

    def post(self, path: str):
        return self.route(path, ("POST",))

    def put(self, path: str):
        return self.route(path, ("PUT",))

    def delete(self, path: str):
        return self.route(path, ("DELETE",))

    # ---- the actual ASGI interface ---------------------------------------
    async def __call__(self, scope, receive, send):
        assert scope["type"] == "http"
        body = b""
        while True:
            message = await receive()
            body += message.get("body", b"")
            if not message.get("more_body"):
                break
        method = scope.get("method", "GET")
        path = scope.get("path", "/") or "/"
        for m, pattern, _names, fn in self._routes:
            if m != method:
                continue
            match = pattern.match(path)
            if not match:
                continue
            scope = dict(scope)
            scope["path_params"] = match.groupdict()
            request = Request(scope, body)
            try:
                out = fn(request)
                if asyncio.iscoroutine(out):
                    out = await out
            except Exception as e:  # noqa: BLE001 — app error -> 500
                out = Response({"error": f"{type(e).__name__}: {e}"},
                               status=500)
            resp = out if isinstance(out, Response) else Response(out)
            await _send_response(send, resp)
            return
        await _send_response(
            send, Response({"error": f"no route for {method} {path}"},
                           status=404))


async def _send_response(send, resp: Response) -> None:
    pairs = getattr(resp, "header_list", None) or list(resp.headers.items())
    await send({"type": "http.response.start", "status": resp.status,
                "headers": [(k.encode(), v.encode()) for k, v in pairs]})
    await send({"type": "http.response.body", "body": resp.body})


# ---- replica-side driver ---------------------------------------------------

def run_asgi_request(asgi_app, request: Dict[str, Any],
                     loop: Optional[asyncio.AbstractEventLoop] = None
                     ) -> Dict[str, Any]:
    """Drive one request through an ASGI app and collect the response.

    ``request``: {"method", "path", "query_string", "headers", "body"} as
    forwarded by the proxy. Returns {"status", "headers", "body"}.
    """
    scope = {
        "type": "http",
        "asgi": {"version": "3.0"},
        "http_version": "1.1",
        "method": request.get("method", "GET"),
        "path": request.get("path", "/") or "/",
        "raw_path": (request.get("path", "/") or "/").encode(),
        "query_string": (request.get("query_string") or "").encode(),
        "headers": [(k.lower().encode(), v.encode())
                    for k, v in (
                        request["headers"].items()
                        if isinstance(request.get("headers"), dict)
                        else (request.get("headers") or []))],
    }
    body = request.get("body") or b""
    if isinstance(body, str):
        body = body.encode()
    sent = {"body": False}

    async def receive():
        if sent["body"]:
            return {"type": "http.disconnect"}
        sent["body"] = True
        return {"type": "http.request", "body": body, "more_body": False}

    out = {"status": 500, "headers": {}, "body": b""}
    chunks: List[bytes] = []

    async def send(message):
        if message["type"] == "http.response.start":
            out["status"] = message["status"]
            pairs = [((k.decode() if isinstance(k, bytes) else k),
                      (v.decode() if isinstance(v, bytes) else v))
                     for k, v in message.get("headers", [])]
            # header_list keeps duplicates (Set-Cookie); the dict is the
            # backward-compatible view (last value wins).
            out["header_list"] = pairs
            out["headers"] = dict(pairs)
        elif message["type"] == "http.response.body":
            chunks.append(message.get("body", b""))

    async def _drive():
        await asgi_app(scope, receive, send)

    if loop is not None:
        asyncio.run_coroutine_threadsafe(_drive(), loop).result(timeout=120)
    else:
        asyncio.run(_drive())
    out["body"] = b"".join(chunks)
    return out


class _IngressLoop:
    """One persistent event loop per replica process for ASGI dispatch."""

    _lock = threading.Lock()
    _loop: Optional[asyncio.AbstractEventLoop] = None

    @classmethod
    def get(cls) -> asyncio.AbstractEventLoop:
        with cls._lock:
            if cls._loop is None or cls._loop.is_closed():
                loop = asyncio.new_event_loop()
                threading.Thread(target=loop.run_forever, daemon=True,
                                 name="serve-asgi").start()
                cls._loop = loop
            return cls._loop


def ingress(asgi_app):
    """Class decorator binding an ASGI app to a deployment (reference:
    `@serve.ingress(fastapi_app)`): HTTP requests hitting the app's route
    prefix run through the ASGI app inside the replica. The deployment
    instance is exposed to handlers as ``request.scope["deployment"]``."""

    def decorator(cls):
        class ASGIIngress(cls):
            _serve_asgi_app = asgi_app

            def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
                app = self._serve_asgi_app

                async def _with_self(scope, receive, send):
                    scope = dict(scope)
                    scope["deployment"] = self
                    await app(scope, receive, send)

                return run_asgi_request(_with_self, request or {},
                                        loop=_IngressLoop.get())

        ASGIIngress.__name__ = getattr(cls, "__name__", "ASGIIngress")
        ASGIIngress.__qualname__ = ASGIIngress.__name__
        ASGIIngress._serve_is_asgi = True
        return ASGIIngress

    return decorator
