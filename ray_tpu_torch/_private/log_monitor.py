"""Per-node log aggregation: tail worker logs, publish lines to drivers.

Reference: `python/ray/_private/log_monitor.py:103` — a per-node monitor
tails `session_latest/logs/*` and publishes new lines over GCS pubsub;
every driver subscribes and echoes them, which is how a `print` inside a
remote task shows up on the driver's terminal.

Here the monitor runs as an async task inside the raylet (no extra
process): it scans `{session_dir}/logs/worker-*.out` and `worker-*.err`,
remembers a byte offset per file, and publishes batches of complete
lines on the "logs" pubsub channel (stderr batches carry ``is_err`` so
the driver renders them distinctly). Runtime noise (jax backend preload
warnings every worker emits at import) is filtered before publishing.

Per-task attribution: workers bracket each executing task with marker
lines (``task_marker``/``task_end_marker``) in their own log stream.
The monitor consumes the markers (never echoed) and tags every
published batch with the task/actor the lines belong to; the same
marker protocol lets ``read_task_lines`` reconstruct one task's output
from a full log file for ``util.state.get_log(task_id=...)``.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Tuple

# Lines every spawned worker emits on interpreter start that carry no
# user signal; echoing them once per worker would drown the driver.
_NOISE = [
    re.compile(rb"WARNING:.*xla_bridge.*experimental"),
    re.compile(rb"^\s*$"),
]

_FILE_RE = re.compile(r"worker-([0-9a-f]+)\.(out|err)$")

# Per-file, per-scan read cap: a crash-looping task spewing hundreds of MB
# must not block the raylet event loop in one read() or ship a single
# giant pubsub message. The remainder is picked up next scan.
MAX_READ_PER_SCAN = 256 * 1024

# ---------------------------------------------------------------- markers
# Worker-side task attribution protocol: `::rtpu:task:<task_id_hex>:
# <actor_id_hex or ->:<name>::` opens a task's output span in the
# stream, `::rtpu:task:end:<task_id_hex>::` closes it. Markers are
# consumed here — they never reach the driver terminal.
_MARKER_PREFIX = "::rtpu:task:"
_MARKER_RE = re.compile(
    rb"^::rtpu:task:(end:)?([0-9a-f]+)(?::([0-9a-f-]*):(.*?))?::\s*$")


def task_marker(task_id_hex: str, actor_id_hex: str = "",
                name: str = "") -> str:
    # The name rides along for future use but must not break parsing.
    safe_name = name.replace(":", "_").replace("\n", " ")
    return (f"{_MARKER_PREFIX}{task_id_hex}:{actor_id_hex or '-'}:"
            f"{safe_name}::")


def task_end_marker(task_id_hex: str) -> str:
    return f"{_MARKER_PREFIX}end:{task_id_hex}::"


def _parse_marker(line: bytes) -> Optional[Tuple[bool, str, str]]:
    """Returns (is_end, task_id_hex, actor_id_hex) or None."""
    m = _MARKER_RE.match(line.strip())
    if not m:
        return None
    is_end = m.group(1) is not None
    actor = (m.group(3) or b"").decode("ascii", "replace")
    return (is_end, m.group(2).decode("ascii"),
            "" if actor in ("", "-") else actor)


class LogMonitor:
    """Incremental tailer for one node's worker log directory."""

    def __init__(self, log_dir: str,
                 pid_of: Optional[Callable[[str], Optional[int]]] = None,
                 max_read: int = MAX_READ_PER_SCAN):
        self.log_dir = log_dir
        self._pid_of = pid_of or (lambda _wid: None)
        self._max_read = max_read
        self._offsets: Dict[str, int] = {}
        # Trailing bytes of a file that did not end in a newline yet.
        self._partial: Dict[str, bytes] = {}
        # path -> (task_id_hex, actor_id_hex) currently open in that
        # stream (markers persist across scans).
        self._current_task: Dict[str, Tuple[str, str]] = {}

    def scan(self) -> List[dict]:
        """Collect new complete lines per worker file since the last scan.
        Returns pubsub-ready messages: {worker_id, pid, lines, is_err,
        task_id, actor_id} — one message per contiguous same-task run of
        lines, so attribution survives task switches mid-scan."""
        out: List[dict] = []
        try:
            names = os.listdir(self.log_dir)
        except FileNotFoundError:
            return out
        for name in names:
            m = _FILE_RE.search(name)
            if not m:
                continue
            path = os.path.join(self.log_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            offset = self._offsets.get(path, 0)
            if size <= offset:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    data = f.read(min(size - offset, self._max_read))
            except OSError:
                continue
            self._offsets[path] = offset + len(data)
            data = self._partial.pop(path, b"") + data
            if not data.endswith(b"\n"):
                data, _, rest = data.rpartition(b"\n")
                if rest:
                    self._partial[path] = rest
                if not data:
                    continue
            wid = m.group(1)
            is_err = m.group(2) == "err"
            pid = self._pid_of(wid)
            # Split the batch into contiguous same-task segments,
            # consuming markers as they pass.
            segment: List[bytes] = []

            def flush_segment():
                if not segment:
                    return
                task, actor = self._current_task.get(path, ("", ""))
                out.append({
                    "worker_id": wid,
                    "pid": pid,
                    "lines": [ln.decode("utf-8", "replace")
                              for ln in segment],
                    "is_err": is_err,
                    "task_id": task or None,
                    "actor_id": actor or None,
                })
                segment.clear()

            for ln in data.split(b"\n"):
                marker = _parse_marker(ln) if ln.startswith(b"::rtpu:") \
                    else None
                if marker is not None:
                    flush_segment()
                    is_end, task, actor = marker
                    if is_end:
                        cur = self._current_task.get(path)
                        if cur is not None and cur[0] == task:
                            self._current_task.pop(path, None)
                    else:
                        self._current_task[path] = (task, actor)
                    continue
                if ln and not any(p.search(ln) for p in _NOISE):
                    segment.append(ln)
            flush_segment()
        return out


def read_task_lines(path: str, task_id_hex: Optional[str] = None,
                    max_lines: int = 0,
                    max_bytes: int = 4 * 1024 * 1024) -> List[str]:
    """Full-file scan with the marker state machine: the lines belonging
    to ``task_id_hex`` (or all non-marker lines when None). Used by the
    raylet's ``get_log`` RPC — log files outlive their workers, so this
    also serves dead workers. ``max_lines`` > 0 keeps only the tail."""
    try:
        fsize = os.path.getsize(path)
        with open(path, "rb") as f:
            if fsize > max_bytes:
                f.seek(fsize - max_bytes)
                f.readline()  # drop the probably-partial first line
            data = f.read(max_bytes)
    except OSError:
        return []
    out: List[str] = []
    current: Optional[str] = None
    for ln in data.split(b"\n"):
        marker = _parse_marker(ln) if ln.startswith(b"::rtpu:") else None
        if marker is not None:
            is_end, task, _actor = marker
            current = None if is_end else task
            continue
        if not ln:
            continue
        if task_id_hex is not None and current != task_id_hex:
            continue
        out.append(ln.decode("utf-8", "replace"))
    if max_lines > 0:
        out = out[-max_lines:]
    return out


def tail_file(path: str, max_lines: int,
              max_bytes: int = 64 * 1024) -> List[str]:
    """Last ``max_lines`` non-marker lines of a log file (raylet-side
    capture at worker exit for death-error enrichment)."""
    return read_task_lines(path, task_id_hex=None, max_lines=max_lines,
                           max_bytes=max_bytes)


def echo_to_driver(message: dict, node_host: str, write) -> None:
    """Driver-side rendering of one pubsub "logs" message (reference
    format: `(pid=…, ip=…) line`; stderr batches marked so tracebacks
    read distinctly from prints). Also renders ERROR-severity cluster
    events the GCS broadcasts on the same channel."""
    event = message.get("cluster_event")
    if event is not None:
        node = (event.get("node_id") or "")[:12]
        write(f"[cluster event] {event.get('severity')} "
              f"{event.get('type')}"
              + (f" (node {node})" if node else "")
              + f": {event.get('message')}\n")
        return
    pid = message.get("pid")
    err = " [stderr]" if message.get("is_err") else ""
    prefix = f"({'pid=' + str(pid) + ', ' if pid else ''}ip={node_host})"
    for line in message.get("lines", ()):
        write(f"{prefix}{err} {line}\n")
