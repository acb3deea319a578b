"""Control-plane RPC: asyncio TCP with length-prefixed pickled frames.

Role-equivalent to the reference's `src/ray/rpc/` gRPC scaffolding plus the
instrumented asio event loop (`asio/instrumented_io_context.h:27`,
`event_stats.h:104`): every server lives on a dedicated event-loop thread, all
handler invocations are latency-tracked, and clients support concurrent
in-flight calls with per-call timeouts and automatic reconnect.

This plane is hardware-agnostic (DCN-level) by design — tensors NEVER travel
here; they move through the ring collectives on the card (see
ray_tpu_torch.util.collective) or through the shared-memory object store.

Wire format: 8-byte big-endian length || pickle((req_id, kind, method, payload)).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import pickle
import socket
import struct
import threading
import time
import traceback
from collections import defaultdict, deque
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

_HEADER = struct.Struct(">Q")

_KIND_REQUEST = 0
_KIND_RESPONSE = 1
_KIND_ERROR = 2

# Payloads bigger than this are rejected to catch framing corruption early.
_MAX_FRAME = 1 << 33


# Strong references for fire-and-forget tasks. asyncio's loop holds only
# WEAK references to tasks (see the create_task docs warning): a pending
# task whose await-chain isn't externally reachable can be garbage-
# collected mid-execution and silently vanish — under suite-level GC
# pressure this kills daemons (lease dispatchers, read loops, GCS
# schedulers) and everything downstream wedges. Every fire-and-forget
# spawn in the runtime goes through spawn_task() so the task is pinned
# until done.
_BACKGROUND_TASKS: set = set()

# Every live EventLoopThread, for wedge diagnostics (dump_event_loops).
import weakref as _weakref  # noqa: E402

_ALL_LOOPS: "_weakref.WeakSet" = _weakref.WeakSet()


def dump_event_loops(file=None) -> None:
    """Wedge diagnostic: for every EventLoopThread in this process, print
    its submit-queue state and the *coroutine* stack of every parked
    asyncio task. faulthandler shows only OS-thread stacks — an idle
    `select()` loop with twenty tasks awaiting lost replies looks
    healthy in a thread dump; this shows where each coroutine actually
    awaits. Best-effort and lock-free: meant to run from a signal
    handler in a process that may be wedged."""
    import io as _io
    import sys

    out = _io.StringIO()
    for elt in list(_ALL_LOOPS):
        try:
            thread = getattr(elt, "_thread", None)
            out.write(
                f"--- EventLoopThread {getattr(thread, 'name', '?')} "
                f"alive={bool(thread and thread.is_alive())} "
                f"pending={len(elt._pending)} "
                f"drain_scheduled={elt._drain_scheduled} "
                f"inflight={len(elt._inflight)} "
                f"stopped={elt._stopped}\n")
            # all_tasks iterates a WeakSet the live loop mutates
            # concurrently — "Set changed size during iteration"
            # RuntimeErrors are transient, so retry a few times before
            # giving up on this loop's task list.
            tasks = None
            err = None
            for _ in range(5):
                try:
                    tasks = [t for t in asyncio.all_tasks(elt.loop)]
                    break
                except RuntimeError as e:
                    err = e
                    continue
                except Exception as e:
                    err = e
                    break
            if tasks is None:
                out.write(f"    (all_tasks failed: {err!r})\n")
                continue
            for t in tasks:
                try:
                    coro = t.get_coro()
                    name = getattr(coro, "__qualname__", repr(coro))
                    out.write(f"  task {name} done={t.done()}\n")
                    for frame in t.get_stack(limit=16):
                        code = frame.f_code
                        out.write(
                            f"    {code.co_filename}:{frame.f_lineno} "
                            f"in {code.co_name}\n")
                except Exception as e:
                    out.write(f"  (task dump failed: {e!r})\n")
        except Exception as e:
            out.write(f"--- (loop dump failed: {e!r})\n")
    (file or sys.stderr).write(out.getvalue())
    try:
        (file or sys.stderr).flush()
    except Exception:
        pass


def dump_thread_stacks(file=None) -> None:
    """Wedge diagnostic companion to dump_event_loops: the *OS-thread*
    Python stacks of every thread in this process. A wedged worker
    blocked in user code (a lock, a collective, a C extension holding
    the GIL between bytecodes) never shows up in the coroutine dump —
    this is the half that does. Lock-free and best-effort, implemented
    inline (no imports at dump time): a signal handler in a wedged
    process must not touch the import machinery."""
    import io as _io
    import sys
    import threading
    import traceback

    out = _io.StringIO()
    out.write(f"--- Python thread stacks (pid {os.getpid()}, "
              f"{threading.active_count()} threads) ---\n")
    try:
        frames = sys._current_frames()
    except Exception as e:  # noqa: BLE001
        frames = {}
        out.write(f"    (sys._current_frames failed: {e!r})\n")
    names = {t.ident: t for t in threading.enumerate()}
    for ident, frame in frames.items():
        t = names.get(ident)
        name = t.name if t else f"thread-{ident}"
        daemon = " daemon" if (t and t.daemon) else ""
        out.write(f"--- thread {name}{daemon} ---\n")
        try:
            out.write("".join(traceback.format_stack(frame)))
        except Exception as e:  # noqa: BLE001
            out.write(f"    (stack dump failed: {e!r})\n")
    (file or sys.stderr).write(out.getvalue())
    try:
        (file or sys.stderr).flush()
    except Exception:
        pass


def install_coroutine_dump_signal() -> None:
    """Register SIGUSR2 → dump_event_loops + dump_thread_stacks on
    stderr (the worker's .err file, so the raylet's worker_exit_tail
    capture includes a final stack on wedged-worker kills).
    Python-level handler (runs between bytecodes on the main thread):
    fine for the parked-coroutine wedge class where the loops are idle
    and the main thread sits in an interruptible wait."""
    import signal

    def _h(signum, frame):
        try:
            dump_event_loops()
        except Exception:
            pass
        try:
            dump_thread_stacks()
        except Exception:
            pass

    try:
        signal.signal(signal.SIGUSR2, _h)
    except (ValueError, OSError):
        pass  # non-main thread or unsupported platform


def spawn_task(coro: Awaitable, loop=None) -> "asyncio.Task":
    """ensure_future + a strong reference held until the task finishes."""
    task = asyncio.ensure_future(coro, loop=loop) if loop is not None \
        else asyncio.ensure_future(coro)
    _BACKGROUND_TASKS.add(task)
    task.add_done_callback(_BACKGROUND_TASKS.discard)
    return task


def debug_log(tag: str, env_var: str = "RAY_TPU_DEBUG_SCHED"):
    """Env-gated stderr debug logger shared by the runtime daemons."""
    import sys

    if not os.environ.get(env_var):
        return lambda *m: None
    return lambda *m: print(f"[{tag} {time.monotonic():.3f}]", *m,
                            file=sys.stderr, flush=True)


class RpcError(Exception):
    """Remote handler raised; carries the remote traceback string."""


# Methods the sync transport may safely RE-SEND after a connection drop
# mid-call: the server might have executed the first attempt with only the
# reply lost, so everything here must be a read, a keyed upsert, or a call
# the server dedups by id. Anything else (e.g. return_worker, refcount
# releases, id allocators) surfaces ConnectionLost to the caller instead.
_RETRY_SAFE_PREFIXES = (
    "get_", "list_", "kv_", "wait_", "cluster_", "available_", "node_",
    "store_", "metrics_", "contains_", "object_", "runtime_env_",
)
_RETRY_SAFE_METHODS = frozenset({
    "heartbeat", "ping", "client_ping", "poll", "pubsub_seq",
    "register_node", "register_worker", "register_actor", "register_job",
    "create_placement_group", "remove_placement_group",
    "create_object", "seal_object", "pin_object", "unpin_object",
    "kill_actor", "client_kill_actor", "client_cancel",
    "client_disconnect", "client_export_function", "client_get_actor",
    "mark_job_finished", "push_task_events",
    "add_borrower", "release_borrower",  # server-side key dedup
})


def _retry_safe(method: str) -> bool:
    return (method in _RETRY_SAFE_METHODS
            or method.startswith(_RETRY_SAFE_PREFIXES))


class ConnectionLost(Exception):
    pass


class TaskCancelled(RuntimeError):
    """Set on a submit() future whose coroutine was cancelled.

    Deliberately Exception-derived: on stock CPython >= 3.8,
    concurrent.futures.CancelledError aliases asyncio's
    BaseException-derived CancelledError, which would sail through
    every `except Exception` on the submitting thread."""


class EventStats:
    """Per-handler count/total-time tracking (reference: event_stats.h:104)."""

    def __init__(self):
        self._stats: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))
        self._lock = threading.Lock()

    def record(self, name: str, elapsed: float) -> None:
        with self._lock:
            count, total = self._stats[name]
            self._stats[name] = (count + 1, total + elapsed)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"count": c, "total_s": t, "mean_s": t / c if c else 0.0}
                for k, (c, t) in self._stats.items()
            }


async def _read_frame(reader: asyncio.StreamReader):
    """Returns ((req_id, kind, method, payload), is_msgpack).

    Frames from Python peers are pickled (protocol >= 2, body starts
    0x80).  Cross-language clients (the C++ frontend, `cpp/`) send the
    same 4-tuple msgpack-encoded instead — a fixarray first byte, which
    can never collide with pickle's PROTO opcode.  Reference analogue:
    the msgpack boundary of `python/ray/cross_language.py`."""
    header = await reader.readexactly(_HEADER.size)
    (length,) = _HEADER.unpack(header)
    if length > _MAX_FRAME:
        raise ConnectionLost(f"oversized frame: {length}")
    body = await reader.readexactly(length)
    if body[:1] == b"\x80":
        return pickle.loads(body), False
    req_id, kind, method, payload = _msgpack().unpackb(body, raw=False)
    return (req_id, kind, method, payload), True


def _msgpack():
    """msgpack, which only a cross-language frame needs."""
    try:
        import msgpack
    except ImportError as exc:
        raise ImportError(
            "a msgpack frame arrived (a cross-language caller such as the "
            "C++ frontend, the driver transports' slice) and msgpack is "
            "not installed in this process") from exc
    return msgpack


def _encode_frame(msg) -> bytes:
    body = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    return _HEADER.pack(len(body)) + body


def _encode_msgpack_frame(msg) -> bytes:
    body = _msgpack().packb(list(msg), use_bin_type=True)
    return _HEADER.pack(len(body)) + body


class EventLoopThread:
    """An asyncio loop running on a daemon thread; sync-callable.

    submit() coalesces cross-thread wakeups: run_coroutine_threadsafe
    pays one self-pipe write syscall + selector wakeup PER CALL, so a
    burst of N task submissions from the driver thread wakes the loop N
    times (the reference's Cython core worker amortizes this in its C++
    io_context; our analogue is batching at the loop boundary). Here
    submissions append to a deque and only the empty→non-empty
    transition schedules one drain callback that starts the whole batch
    FIFO — submission order is preserved exactly as with
    run_coroutine_threadsafe."""

    def __init__(self, name: str = "ray_tpu_torch-io"):
        _ALL_LOOPS.add(self)
        self.loop = asyncio.new_event_loop()
        self._pending: deque = deque()
        self._pending_lock = threading.Lock()
        self._drain_scheduled = False
        self._coalesce = os.environ.get(
            "RAY_TPU_SUBMIT_COALESCE", "1") != "0"
        self._stopped = False
        # Caller-side stop latch: set at stop() entry (NOT on the loop
        # thread) so submits racing a shutdown fail fast even when the
        # loop thread is wedged and _shutdown never runs.
        self._stop_requested = False
        # Futures whose coroutine was started but not yet resolved.
        # Mutated only on the loop thread; swept by stop() after the
        # thread is joined (so no concurrent mutation is possible).
        self._inflight: Dict[Any, Any] = {}
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro: Awaitable, timeout: Optional[float] = None):
        if threading.current_thread() is self._thread:
            # Blocking on our own loop can never complete — it stalls the
            # loop for the full timeout (observed: GCS heartbeat outages
            # from close() in handlers). Fail loudly instead.
            coro.close()
            raise RuntimeError(
                "EventLoopThread.run() called from its own loop thread; "
                "use 'await' or asyncio.ensure_future instead")
        return self.submit(coro).result(timeout)

    def submit(self, coro: Awaitable):
        """Schedule `coro` on the loop; returns a concurrent Future.

        Unlike run_coroutine_threadsafe, the returned future is NOT
        cancellable once the drain has started the coroutine (cancel()
        before that point works and the coroutine never runs). No
        current caller cancels submit() futures; holders that need a
        cancellable handle should signal the coroutine directly."""
        if self._stop_requested:
            # stop() has begun (possibly with the loop thread wedged in a
            # task's blocking call, so the loop may never drain again):
            # enqueueing would hang the caller forever. Fail fast.
            coro.close()
            raise RuntimeError("event loop stopping")
        if not self._coalesce:
            return asyncio.run_coroutine_threadsafe(coro, self.loop)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._pending_lock:
            self._pending.append((coro, fut))
            wake = not self._drain_scheduled
            if wake:
                self._drain_scheduled = True
        if wake:
            try:
                self.loop.call_soon_threadsafe(self._drain)
            except RuntimeError:
                # Loop already closed (shutdown race): fail the batch
                # instead of leaving callers waiting forever.
                self._fail_pending("event loop closed")
                raise
        return fut

    # Max submissions started per drain callback. Bounds the length of a
    # single loop iteration under a submit storm: timers (heartbeats)
    # and readable sockets are re-checked between chunks, so a fast
    # submitter can't make the loop unresponsive (measured: uncapped
    # batches reached tens of thousands, stretching iterations to
    # ~300 ms and starving 5 ms timers).
    _DRAIN_CHUNK = 256

    def _drain(self):
        if self._stopped:
            # A drain landing between _shutdown and the deferred
            # loop.stop must NOT start tasks — they would never get a
            # step and their futures would hang. Fail them instead.
            self._fail_pending("event loop stopping")
            return
        # One bounded batch per callback: remaining/new entries are
        # handled by a re-scheduled drain on the NEXT loop iteration, so
        # sustained cross-thread submission can't starve other loop work
        # (heartbeats, in-flight reads) the way an unbounded re-check
        # loop would.
        batch = []
        with self._pending_lock:
            while self._pending and len(batch) < self._DRAIN_CHUNK:
                batch.append(self._pending.popleft())
        for coro, fut in batch:
            if not fut.set_running_or_notify_cancel():
                coro.close()  # caller cancelled before we started it
                continue
            try:
                task = self.loop.create_task(coro)
            except Exception as e:
                fut.set_exception(e)
                continue
            self._inflight[task] = fut
            task.add_done_callback(
                lambda t, f=fut: self._copy_result(t, f))
        with self._pending_lock:
            if self._pending:
                self.loop.call_soon(self._drain)
            else:
                self._drain_scheduled = False

    def _copy_result(self, task: "asyncio.Task", fut) -> None:
        self._inflight.pop(task, None)
        if task.cancelled():
            fut.set_exception(TaskCancelled("coroutine cancelled"))
            return
        exc = task.exception()
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(task.result())

    def stop(self):
        self._stop_requested = True

        def _shutdown():
            self._stopped = True
            self._fail_pending("event loop stopping")
            tasks = list(asyncio.all_tasks(self.loop))
            for task in tasks:
                task.cancel()

            # Stop only after the cancellations have fully landed:
            # delivering CancelledError takes one loop iteration, and
            # the done-callbacks that resolve submit() futures run one
            # iteration after THAT — stopping immediately would strand
            # both. The gather resumes after every per-task done
            # callback already added (callbacks fire in add order), so
            # by the time we stop, every future is resolved. Bounded:
            # a task that swallows cancellation can't wedge stop().
            async def _stop_when_done():
                try:
                    await asyncio.wait_for(
                        asyncio.gather(*tasks, return_exceptions=True),
                        timeout=2.0)
                except Exception:
                    pass
                self.loop.stop()

            spawn_task(_stop_when_done(), loop=self.loop)

        try:
            self.loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:
            pass  # loop already closed (double stop)
        self._thread.join(timeout=5)
        # Close the loop so later submit()s fail fast in
        # call_soon_threadsafe instead of silently enqueueing onto a
        # dead loop (only if the thread really exited — closing a
        # running loop raises).
        if not self._thread.is_alive():
            try:
                self.loop.close()
            except RuntimeError:
                pass
        # Submissions racing between _shutdown's flush and the close
        # above would be orphaned (their call_soon'd drain never runs)
        # — flush again now that the loop is down.
        self._fail_pending("event loop stopped")
        # Backstop for started-but-unresolved coroutines: a task whose
        # final done-callback didn't get a loop iteration (e.g. its
        # chunk completed in the same iteration the stop task first
        # ran) would leave its future RUNNING forever. The loop thread
        # is dead here, so sweeping is race-free.
        if not self._thread.is_alive():
            for task, fut in list(self._inflight.items()):
                if fut.done():
                    continue
                if task.done():
                    # The task finished; only its done-callback missed
                    # the loop — deliver the REAL outcome, not a bogus
                    # shutdown error that could trigger spurious
                    # retries of work that actually executed.
                    self._copy_result(task, fut)
                else:
                    fut.set_exception(RuntimeError("event loop stopped"))
            self._inflight.clear()

    def _fail_pending(self, reason: str) -> None:
        with self._pending_lock:
            batch = list(self._pending)
            self._pending.clear()
            self._drain_scheduled = False
        for coro, fut in batch:
            coro.close()
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError(reason))


_global_loop: Optional[EventLoopThread] = None
_global_loop_lock = threading.Lock()


def get_io_loop() -> EventLoopThread:
    global _global_loop
    with _global_loop_lock:
        if _global_loop is None or not _global_loop._thread.is_alive():
            _global_loop = EventLoopThread()
        return _global_loop


Handler = Callable[..., Awaitable[Any]]


class RpcServer:
    """Serves registered async handlers over TCP.

    Handlers have signature ``async def handler(**payload) -> reply``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 io: Optional[EventLoopThread] = None):
        self._host = host
        self._requested_port = port
        self._handlers: Dict[str, Handler] = {}
        self._io = io or get_io_loop()
        self._server: Optional[asyncio.AbstractServer] = None
        self.stats = EventStats()
        self.port: Optional[int] = None

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_service(self, service: object, prefix: str = "") -> None:
        """Register every public async method of an object."""
        for name in dir(service):
            if name.startswith("_"):
                continue
            fn = getattr(service, name)
            if asyncio.iscoroutinefunction(fn):
                self._handlers[prefix + name] = fn

    def start(self) -> int:
        async def _start():
            self._server = await asyncio.start_server(
                self._handle_conn, self._host, self._requested_port
            )
            return self._server.sockets[0].getsockname()[1]

        self.port = self._io.run(_start())
        return self.port

    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self.port)

    async def _handle_conn(self, reader, writer):
        write_lock = asyncio.Lock()
        try:
            while True:
                try:
                    (req_id, kind, method,
                     payload), is_mp = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError,
                        ConnectionLost):
                    break
                except Exception as exc:
                    # Undecodable frame (bad cross-language client or a
                    # pickle the server can't load): framing is
                    # unrecoverable on this connection. Log before
                    # killing it — every in-flight call on the shared
                    # connection is about to see ConnectionLost.
                    import sys

                    print(f"[rpc] closing connection on undecodable "
                          f"frame: {exc!r}", file=sys.stderr, flush=True)
                    break
                if kind != _KIND_REQUEST:
                    continue
                spawn_task(
                    self._dispatch(req_id, method, payload, writer,
                                   write_lock, is_mp)
                )
        finally:
            writer.close()

    async def _dispatch(self, req_id, method, payload, writer, write_lock,
                        is_mp=False):
        start = time.monotonic()
        try:
            handler = self._handlers.get(method)
            if handler is None:
                raise RpcError(f"no handler registered for {method!r}")
            reply = await handler(**payload)
            if is_mp:
                # Cross-language caller: reply must stay in msgpack types
                # (the xlang handlers guarantee this).
                frame = _encode_msgpack_frame(
                    (req_id, _KIND_RESPONSE, method, reply))
            else:
                frame = _encode_frame(
                    (req_id, _KIND_RESPONSE, method, reply))
        except Exception as exc:  # noqa: BLE001 — forwarded to caller
            if is_mp:
                frame = _encode_msgpack_frame(
                    (req_id, _KIND_ERROR, method,
                     [type(exc).__name__, str(exc),
                      traceback.format_exc()]))
            else:
                err = (type(exc).__name__, str(exc),
                       traceback.format_exc(), exc)
                try:
                    frame = _encode_frame((req_id, _KIND_ERROR, method, err))
                except Exception:
                    # Exception object itself unpicklable — string form only.
                    frame = _encode_frame((req_id, _KIND_ERROR, method,
                                           (type(exc).__name__, str(exc),
                                            traceback.format_exc(), None)))
        finally:
            self.stats.record(method, time.monotonic() - start)
        try:
            async with write_lock:
                writer.write(frame)
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, RuntimeError):
            pass

    def stop(self):
        async def _stop():
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()

        try:
            self._io.run(_stop(), timeout=5)
        except Exception:
            pass


class _SyncConn:
    """A blocking request/response socket for one calling thread.

    One request in flight at a time (per-thread), so replies never
    interleave and no framing state is needed beyond the length prefix.
    """

    __slots__ = ("host", "port", "_connect_timeout", "sock", "dead",
                 "owner_thread")

    def __init__(self, host: str, port: int, connect_timeout: float):
        self.host, self.port = host, port
        self._connect_timeout = connect_timeout
        self.sock = None
        self.dead = False
        self.owner_thread = threading.get_ident()
        self._connect()

    def _connect(self):
        deadline = time.monotonic() + self._connect_timeout
        delay = 0.05
        while True:
            try:
                self.sock = socket.create_connection(
                    (self.host, self.port), timeout=self._connect_timeout)
                break
            except OSError:
                if time.monotonic() > deadline:
                    self.dead = True
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            chunk = self.sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionLost(
                    f"connection to {self.host}:{self.port} closed")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks) if len(chunks) != 1 else chunks[0]

    def call(self, method: str, payload: dict, timeout: Optional[float]):
        frame = _encode_frame((0, _KIND_REQUEST, method, payload))
        try:
            try:
                kind, reply = self._roundtrip(frame, timeout)
            except (ConnectionLost, BrokenPipeError, ConnectionResetError,
                    OSError) as first:
                if isinstance(first, socket.timeout):
                    raise
                if not _retry_safe(method):
                    # The server may have executed the request and only the
                    # reply was lost; re-sending a non-idempotent method
                    # would double-execute it (e.g. a duplicated
                    # return_worker offers the same worker handle twice).
                    # Surface the loss instead and let the caller decide.
                    raise
                # Server bounced while this pooled connection sat idle (or
                # died before replying). Reconnect once and retry — only
                # for methods on the idempotent allowlist (reads, keyed
                # upserts with server-side dedup); a restarted control
                # plane is exactly the case this retry exists for.
                self.close()
                self.dead = False
                self._connect()
                kind, reply = self._roundtrip(frame, timeout)
        except socket.timeout:
            # The reply may still arrive later; this connection's framing
            # is now out of step — discard it.
            self.close()
            raise TimeoutError(
                f"rpc {method} to {self.host}:{self.port} timed out "
                f"after {timeout}s") from None
        except (BrokenPipeError, ConnectionResetError, OSError) as e:
            self.close()
            raise ConnectionLost(
                f"connection to {self.host}:{self.port} lost: {e}") from None
        except ConnectionLost:
            self.close()
            raise
        if kind == _KIND_RESPONSE:
            return reply
        name, msg, tb, exc = reply
        if exc is not None and isinstance(exc, Exception):
            raise exc
        raise RpcError(f"{name}: {msg}\n{tb}")

    def _roundtrip(self, frame: bytes, timeout: Optional[float]):
        self.sock.settimeout(self._connect_timeout)
        self.sock.sendall(frame)
        self.sock.settimeout(timeout)
        header = self._recv_exact(_HEADER.size)
        (length,) = _HEADER.unpack(header)
        if length > _MAX_FRAME:
            raise ConnectionLost(f"oversized frame: {length}")
        _req_id, kind, _method, reply = pickle.loads(
            self._recv_exact(length))
        return kind, reply

    def close(self):
        self.dead = True
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass


class RpcClient:
    """Persistent connection to one RpcServer; thread-safe concurrent calls."""

    def __init__(self, host: str, port: int,
                 io: Optional[EventLoopThread] = None,
                 connect_timeout: float = 10.0):
        self.host, self.port = host, port
        self._io = io or get_io_loop()
        self._connect_timeout = connect_timeout
        self._reader = None
        self._writer = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._conn_lock: Optional[asyncio.Lock] = None
        self._write_lock: Optional[asyncio.Lock] = None
        self._closed = False
        self._sync_local = threading.local()
        self._sync_conns: list = []
        self._sync_conns_lock = threading.Lock()

    async def _ensure_connected(self):
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
            self._write_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            # The loop that creates the connection owns it; close() must
            # route the transport close back here.
            self._owner_loop = asyncio.get_running_loop()
            deadline = time.monotonic() + self._connect_timeout
            delay = 0.05
            while True:
                try:
                    self._reader, self._writer = await asyncio.open_connection(
                        self.host, self.port
                    )
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 1.0)
            spawn_task(self._read_loop(self._reader))

    async def _read_loop(self, reader):
        try:
            while True:
                (req_id, kind, method,
                 payload), _is_mp = await _read_frame(reader)
                fut = self._pending.pop(req_id, None)
                if fut is None or fut.done():
                    continue
                if kind == _KIND_RESPONSE:
                    fut.set_result(payload)
                else:
                    name, msg, tb, exc = payload
                    if exc is not None and isinstance(exc, Exception):
                        fut.set_exception(exc)
                    else:
                        fut.set_exception(RpcError(f"{name}: {msg}\n{tb}"))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ConnectionLost, Exception):
            self._writer = None
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost(
                        f"connection to {self.host}:{self.port} lost"))
            self._pending.clear()

    async def acall(self, method: str, timeout: Optional[float] = None, **payload):
        await self._ensure_connected()
        self._next_id += 1
        req_id = self._next_id
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        frame = _encode_frame((req_id, _KIND_REQUEST, method, payload))
        async with self._write_lock:
            self._writer.write(frame)
            await self._writer.drain()
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    def cast(self, method: str, timeout: Optional[float] = 10.0,
             **payload):
        """Fire-and-forget call: schedule `method` on the io loop and
        return immediately; the reply (and any error) is swallowed.

        For telemetry-grade RPCs on hot paths — train-step heartbeats,
        metric rows — where the caller must never block on, or fail
        because of, the control plane. The ``timeout`` still bounds the
        in-flight call so a dead peer cannot accumulate pending futures.
        """

        async def _fire():
            try:
                await self.acall(method, timeout=timeout, **payload)
            except Exception:
                pass  # best-effort by contract

        try:
            self._io.submit(_fire())
        except RuntimeError:
            pass  # io loop stopping: drop, same contract

    def call(self, method: str, timeout: Optional[float] = None, **payload):
        """Blocking call from any non-loop thread.

        Runs over a dedicated per-thread blocking socket rather than the
        shared asyncio connection: a sync caller otherwise pays two
        thread↔loop handoffs per call (~ms-class on a loaded host), which
        dominated the put/get hot path.
        """
        if threading.current_thread() is self._io._thread:
            raise RuntimeError(
                f"RpcClient.call({method!r}) from the io-loop thread would "
                "stall the loop; use 'await client.acall(...)' instead")
        conn = getattr(self._sync_local, "conn", None)
        if conn is None or conn.dead:
            conn = _SyncConn(self.host, self.port, self._connect_timeout)
            self._sync_local.conn = conn
            with self._sync_conns_lock:
                # Prune sockets owned by exited threads (their thread-local
                # ref is gone but this registry would otherwise pin the fd
                # open for the life of the client).
                live = {t.ident for t in threading.enumerate()}
                keep = []
                for c in self._sync_conns:
                    if c.dead:
                        continue
                    if c.owner_thread not in live:
                        c.close()
                        continue
                    keep.append(c)
                keep.append(conn)
                self._sync_conns = keep
        return conn.call(method, payload, timeout)

    def close(self):
        self._closed = True
        with self._sync_conns_lock:
            conns, self._sync_conns = self._sync_conns, []
        for conn in conns:
            conn.close()

        async def _close():
            if self._writer is not None:
                self._writer.close()

        try:
            owner = getattr(self, "_owner_loop", None)
            try:
                current = asyncio.get_running_loop()
            except RuntimeError:
                current = None
            if owner is None:
                return    # never connected; nothing to close
            if current is owner:
                # Closing from the owning loop (a GCS handler, a
                # dashboard handler): blocking would stall the loop for
                # the full timeout — heartbeats stop, nodes get declared
                # dead. Schedule and return.
                spawn_task(_close())
            else:
                # Transports are loop-affine: hand the close to the loop
                # that created the connection, without blocking if we are
                # ourselves on some other loop.
                fut = asyncio.run_coroutine_threadsafe(_close(), owner)
                if current is None:
                    fut.result(2)
        except Exception:
            pass
