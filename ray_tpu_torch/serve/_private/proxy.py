"""HTTP proxy — exposes deployed applications over REST: the port's
counterpart of ``ray_tpu/serve/_private/proxy.py``.

Reference: `serve/_private/proxy.py` (per-node ProxyActor on uvicorn).
The JAX package's proxy runs aiohttp; this one is an HTTP/1.1 server
written on ``asyncio`` streams from the standard library, on a dedicated
event-loop thread inside the proxy actor, so the port's ingress needs no
package beyond Python's own. The wire behaviour is the reference's:

* Routing: the first path segment picks the application (``/`` -> app
  "default"); ``/-/healthz`` answers ``{"ok": true}`` and ``/-/routes``
  maps each app to its ``route_prefix``. The route table is
  push-invalidated (long-polled from the controller, ``route_plane.py``),
  so the request hot path never does a controller round trip.
* A JSON body decodes to a Python value, any other body passes as text
  (utf-8, ``replace``), an empty one means no argument. Success is
  ``{"result": ...}``; an unknown app 404 ``{"error": "no application
  '<app>'"}``; a failed call 500 ``{"error": "<Type>: <msg>"}``.
* ``stream=True`` deployments answer chunked ``text/plain;
  charset=utf-8``: bytes and str chunks as they are, anything else as
  ``json.dumps(item) + "\\n"``, each flushed as it comes.
* ASGI routes (``@serve.ingress``) forward ``{method, path (after the
  route prefix), query_string, headers (a list of pairs), body}`` and
  write back the replica's status, headers and body.
* Request bodies up to ``MAX_BODY_BYTES`` (256 MiB, aiohttp's
  ``client_max_size`` there), by ``Content-Length`` or chunked; past it
  413. Keep-alive as HTTP/1.1 has it, ``Connection: close`` honoured.

Every handle call runs in the loop's executor, off the loop, with the
reference's 120 s timeouts; the executor has ``CALL_THREADS`` threads,
which caps the requests in flight at once (the rest queue in order).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import http
import json
import threading
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve._private.route_plane import RoutePlane

MAX_BODY_BYTES = 256 * 1024 * 1024
CALL_THREADS = 32              # handle calls in flight at once
CALL_TIMEOUT_S = 120.0
KEEPALIVE_S = 75.0             # an idle connection closes after this
MAX_LINE = 64 * 1024           # request line, one header or a chunk size
MAX_HEADERS = 128

_STOP = object()


class _BadRequest(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


def _json_body(value: Any) -> bytes:
    return json.dumps(value).encode()


def _decode(raw: bytes) -> Any:
    """A JSON body as its value, any other as text; None when empty."""
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return raw.decode("utf-8", "replace")


def _status_line(status: int) -> bytes:
    try:
        phrase = http.HTTPStatus(status).phrase
    except ValueError:
        phrase = ""
    return f"HTTP/1.1 {status} {phrase}\r\n".encode("latin-1")


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        return await reader.readuntil(b"\n")
    except asyncio.IncompleteReadError as e:
        return e.partial
    except asyncio.LimitOverrunError:
        raise _BadRequest(431, "line too long") from None


async def _read_head(reader: asyncio.StreamReader, first: bytes
                     ) -> Tuple[str, str, str, List[Tuple[str, str]]]:
    """(method, target, version, headers) of one request whose request
    line is ``first``; headers as received, duplicates kept."""
    parts = first.decode("latin-1").strip().split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(400, "malformed request line")
    method, target, version = parts
    headers: List[Tuple[str, str]] = []
    while True:
        line = await _read_line(reader)
        if not line.endswith(b"\n"):
            raise _BadRequest(400, "connection closed in the headers")
        line = line.rstrip(b"\r\n")
        if not line:
            return method.upper(), target, version, headers
        if len(headers) >= MAX_HEADERS:
            raise _BadRequest(431, "too many headers")
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise _BadRequest(400, "malformed header")
        headers.append((name, value.strip()))


def _header(headers: List[Tuple[str, str]], name: str) -> Optional[str]:
    name = name.lower()
    found = [v for k, v in headers if k.lower() == name]
    return ", ".join(found) if found else None


async def _read_body(reader: asyncio.StreamReader, writer,
                     headers: List[Tuple[str, str]]) -> bytes:
    """The request body: ``Content-Length`` bytes exactly, or a chunked
    body with its trailers read off; 413 past ``MAX_BODY_BYTES``."""
    te = (_header(headers, "transfer-encoding") or "").lower()
    length = _header(headers, "content-length")
    chunked = "chunked" in te
    if not chunked and length is None:
        return b""
    try:
        n = 0 if chunked else int(length)
        if n < 0:
            raise ValueError(length)
        if n > MAX_BODY_BYTES:
            raise _BadRequest(413, _too_large(n))
        if (_header(headers, "expect") or "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if not chunked:
            return await reader.readexactly(n)
        out = bytearray()
        while True:
            size_line = await _read_line(reader)
            size = int(size_line.split(b";", 1)[0].strip(), 16)
            if size < 0:
                raise ValueError(size)
            if size == 0:
                while (await _read_line(reader)).strip():   # trailers
                    pass
                return bytes(out)
            if len(out) + size > MAX_BODY_BYTES:
                raise _BadRequest(413, _too_large(len(out) + size))
            out += await reader.readexactly(size)
            if (await reader.readexactly(2)) != b"\r\n":
                raise ValueError("chunk without its CRLF")
    except (ValueError, asyncio.IncompleteReadError):
        raise _BadRequest(400, "malformed body") from None


def _too_large(n: int) -> str:
    return (f"Maximum request body size {MAX_BODY_BYTES} exceeded, "
            f"actual body size {n}")


@ray_tpu_torch.remote(num_cpus=0.5, max_concurrency=16)
class ProxyActor(RoutePlane):
    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        from ray_tpu_torch.serve._private.controller import (
            get_or_create_controller,
        )

        self._requests_served = 0
        self._pre_init_route_plane()
        self.port = None
        started = threading.Event()
        self._host = host
        self._loop_thread = threading.Thread(
            target=self._serve_forever, args=(port, started),
            daemon=True, name="serve-proxy")
        self._loop_thread.start()
        started.wait(timeout=30)
        # Shared push-invalidated route table (route_plane.py).
        self._init_route_plane(get_or_create_controller())

    # ---- http -------------------------------------------------------------
    def _serve_forever(self, port: int, started: threading.Event):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(
            max_workers=CALL_THREADS, thread_name_prefix="serve-proxy-call"))
        # Loopback by default: the ingress has no authentication, so it is
        # only exposed on all interfaces when the operator explicitly asks
        # (serve.start(http_host="0.0.0.0") or proxy_location="EveryNode",
        # where cross-node traffic is the point).
        server = loop.run_until_complete(asyncio.start_server(
            self._connection, self._host, port, limit=MAX_LINE))
        self.port = server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """One client connection: requests in order until the client or
        either side's ``Connection: close`` ends it."""
        try:
            while True:
                try:
                    first = await asyncio.wait_for(_read_line(reader),
                                                   KEEPALIVE_S)
                except asyncio.TimeoutError:
                    return
                if not first.strip():
                    if not first:
                        return               # the client closed
                    continue                 # a stray CRLF between requests
                try:
                    method, target, version, headers = await _read_head(
                        reader, first)
                    body = await _read_body(reader, writer, headers)
                except _BadRequest as e:
                    await self._respond(writer, e.status,
                                        _json_body({"error": str(e)}),
                                        close=True)
                    return
                conn = (_header(headers, "connection") or "").lower()
                close = ("close" in conn if version == "HTTP/1.1"
                         else "keep-alive" not in conn)
                close = await self._request(writer, method, target,
                                            headers, body, close)
                if close:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _respond(self, writer, status: int, body: bytes, *,
                       headers: Optional[List[Tuple[str, str]]] = None,
                       close: bool = False, head: bool = False) -> None:
        """One response framed by its length; ``headers`` (an ASGI
        reply's) replace the JSON content type."""
        pairs = list(headers) if headers is not None else [
            ("Content-Type", "application/json; charset=utf-8")]
        if not any(k.lower() == "content-type" for k, _ in pairs):
            pairs.append(("Content-Type", "application/octet-stream"))
        pairs.append(("Content-Length", str(len(body))))
        pairs.append(("Connection", "close" if close else "keep-alive"))
        out = [_status_line(status)]
        out += [f"{k}: {v}\r\n".encode() for k, v in pairs]
        out.append(b"\r\n")
        if not head:
            out.append(body)
        writer.write(b"".join(out))
        await writer.drain()

    async def _request(self, writer, method: str, target: str,
                       headers: List[Tuple[str, str]], raw: bytes,
                       close: bool) -> bool:
        """Serve one request; returns whether the connection closes."""
        self._requests_served += 1
        loop = asyncio.get_running_loop()
        split = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(split.path) or "/"
        head = method == "HEAD"

        async def respond(status, value):
            await self._respond(writer, status, _json_body(value),
                                close=close, head=head)
            return close

        if path == "/-/healthz":
            return await respond(200, {"ok": True})
        if path == "/-/routes":
            return await respond(200, {a: r.get("route_prefix")
                                       for a, r in self._routes.items()})
        if not self._routes_ready.is_set():
            await loop.run_in_executor(None, self._routes_ready.wait, 10)
        app = path.strip("/").split("/", 1)[0] or "default"
        # A body of up to 256 MiB decodes off the loop, as handle calls run.
        payload = await loop.run_in_executor(None, _decode, raw)
        route = self._routes.get(app)
        if route is None:
            return await respond(404, {"error": f"no application '{app}'"})
        try:
            handle = self._handle_for(app)
        except KeyError as e:
            return await respond(404, {"error": str(e)})
        if route.get("asgi"):
            # ASGI ingress: forward the raw request; the replica drives
            # the app and returns status/headers/body (reference: proxy
            # -> ASGIAppReplicaWrapper).
            prefix = (route.get("route_prefix") or f"/{app}").rstrip("/")
            sub = path
            if sub.startswith(prefix):
                sub = sub[len(prefix):] or "/"
            asgi_req = {
                "method": method,
                "path": sub,
                "query_string": split.query,
                # List of pairs, not a dict: duplicate headers (multiple
                # Cookie/Set-Cookie) must survive the proxy->replica hop.
                "headers": list(headers),
                "body": raw,
            }
            try:
                rep = await loop.run_in_executor(
                    None, lambda: handle.remote(asgi_req)
                    .result(timeout=CALL_TIMEOUT_S))
            except Exception as e:  # noqa: BLE001 — surfaced as HTTP 500
                return await respond(500, {"error":
                                           f"{type(e).__name__}: {e}"})
            pairs = [(k, v) for k, v in (
                rep.get("header_list")
                or list((rep.get("headers") or {}).items()))
                if k.lower() not in ("content-length", "transfer-encoding",
                                     "connection")]
            await self._respond(writer, rep.get("status", 200),
                                rep.get("body", b""), headers=pairs,
                                close=close, head=head)
            return close
        args = (payload,) if payload is not None else ()
        if route.get("stream"):
            return await self._stream(writer, handle, args, close, head)
        try:
            body = await loop.run_in_executor(
                None, lambda: _json_body({"result": handle.remote(*args)
                                          .result(timeout=CALL_TIMEOUT_S)}))
        except Exception as e:  # noqa: BLE001 — surfaced as HTTP 500
            return await respond(500, {"error": f"{type(e).__name__}: {e}"})
        await self._respond(writer, 200, body, close=close, head=head)
        return close

    async def _stream(self, writer, handle, args, close: bool,
                      head: bool) -> bool:
        """A chunked response, one HTTP chunk per item, each flushed. A
        failure after the head is sent ends the connection without the
        last chunk, so the client sees the body cut."""
        writer.write(b"".join([
            _status_line(200),
            b"Content-Type: text/plain; charset=utf-8\r\n",
            b"Transfer-Encoding: chunked\r\n",
            b"Connection: " + (b"close" if close else b"keep-alive"),
            b"\r\n\r\n"]))
        await writer.drain()
        if head:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            return close
        loop = asyncio.get_running_loop()
        try:
            # The router blocks (replica waits, sync submission) — keep it
            # off the event loop, same as the non-streaming path.
            gen = await loop.run_in_executor(
                None, lambda: handle.options(stream=True).remote(*args))
            it = iter(gen)

            def _next():
                try:
                    return next(it)
                except StopIteration:
                    return _STOP

            while True:
                item = await loop.run_in_executor(None, _next)
                if item is _STOP:
                    break
                if isinstance(item, bytes):
                    chunk = item
                elif isinstance(item, str):
                    chunk = item.encode()
                else:
                    chunk = (json.dumps(item) + "\n").encode()
                if chunk:           # an empty chunk would end the body
                    writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                    await writer.drain()
        except Exception:  # noqa: BLE001 — the head is out: cut the body
            return True
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return close

    # ---- actor api --------------------------------------------------------
    def get_port(self) -> int:
        # The server thread publishes the port asynchronously; never hand
        # out None to a client that called right after creation.
        import time as _time

        deadline = _time.monotonic() + 20
        while self.port is None and _time.monotonic() < deadline:
            _time.sleep(0.05)
        return self.port

    def healthz(self) -> bool:
        return True

    def stats(self) -> Dict[str, Any]:
        return {"requests_served": self._requests_served,
                "routes": dict(self._routes)}
