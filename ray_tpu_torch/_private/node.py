"""Node/process management — spawns and supervises the cluster daemons.

Role-equivalent to the reference's `_private/node.py` (start_head_processes /
start_ray_processes): the head starts a GCS server process plus a raylet
process; worker nodes start just a raylet. The port's node counts its
NVIDIA cards as the ``GPU`` resource (``accelerators/gpu.py``) and keeps
its sessions under ``<tmp>/ray_tpu_torch``, apart from the reference's.
Daemon stdout is parsed for the bound port (the daemons print
``GCS_PORT=``/``RAYLET_PORT=`` on boot).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.resources import CPU, GPU, MEM, OBJECT_STORE_MEM


def _read_port(proc: subprocess.Popen, marker: str, timeout: float = 30.0) -> int:
    deadline = time.monotonic() + timeout
    buf = b""
    os.set_blocking(proc.stdout.fileno(), False)
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon exited (code {proc.returncode}) before printing "
                f"{marker}: {buf.decode(errors='replace')}")
        try:
            chunk = proc.stdout.read()
        except (BlockingIOError, TypeError):
            chunk = None
        if chunk:
            buf += chunk
        for line in buf.decode(errors="replace").splitlines():
            if line.startswith(marker):
                os.set_blocking(proc.stdout.fileno(), True)
                return int(line[len(marker):])
        time.sleep(0.01)
    raise TimeoutError(f"daemon did not print {marker} within {timeout}s")


def default_resources(num_cpus: Optional[float] = None,
                      num_gpus: Optional[float] = None,
                      resources: Optional[Dict[str, float]] = None,
                      memory: Optional[int] = None,
                      object_store_memory: Optional[int] = None
                      ) -> Dict[str, float]:
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

    out = dict(resources or {})
    out[CPU] = num_cpus if num_cpus is not None else (os.cpu_count() or 1)
    # Detected, never assumed: a node without cards advertises no GPU.
    detected = GPUAcceleratorManager.get_current_node_num_accelerators()
    if num_gpus is None:
        num_gpus = detected
    if num_gpus:
        out[GPU] = num_gpus
        if num_gpus == detected:
            out.update(GPUAcceleratorManager.get_current_node_extra_resources())
    if memory is None:
        try:
            import psutil

            memory = int(psutil.virtual_memory().available * 0.7)
        except Exception:
            memory = 8 * (1024 ** 3)
    out[MEM] = memory
    out[OBJECT_STORE_MEM] = object_store_memory or GlobalConfig.object_store_memory
    return out


class Node:
    """Launches and owns this host's daemons."""

    def __init__(
        self,
        head: bool = True,
        gcs_addr: Optional[Tuple[str, int]] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        system_config: Optional[Dict] = None,
        session_dir: Optional[str] = None,
        fate_share: bool = True,
        gcs_port: int = 0,
        include_dashboard: bool = False,
    ):
        self.head = head
        self.host = "127.0.0.1"
        # CLI-started nodes outlive the starting process; init()-started
        # ones die with their driver.
        self._fate_share = fate_share
        self._gcs_port = gcs_port
        self.node_id = NodeID.from_random()
        self._procs: list = []
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"session_{time.strftime('%Y%m%d-%H%M%S')}_{uuid.uuid4().hex[:8]}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self._system_config = system_config or {}
        GlobalConfig.initialize(self._system_config)

        if head:
            self.gcs_addr = self._start_gcs()
        else:
            assert gcs_addr is not None
            self.gcs_addr = gcs_addr

        self.resources = default_resources(
            num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
            object_store_memory=object_store_memory)
        self.labels = labels or {}
        self.raylet_addr = self._start_raylet(object_store_memory)
        self.dashboard_url: Optional[str] = None
        if head and include_dashboard:
            try:
                self.dashboard_url = self._start_dashboard()
            except Exception as e:
                # Non-essential: a broken dashboard (missing aiohttp,
                # port trouble) must not take the head node down.
                sys.stderr.write(
                    f"[node] dashboard failed to start ({e}); "
                    "continuing without it\n")
        if fate_share:
            atexit.register(self.shutdown)

    # ------------------------------------------------------------------ procs
    def _daemon_env(self):
        env = dict(os.environ)
        env.setdefault("PYTHONUNBUFFERED", "1")
        # The daemons, and the workers they start, import the same copy of
        # the package as this process, wherever it was started from.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p and p != root])
        return env

    def _start_gcs(self) -> Tuple[str, int]:
        log = open(os.path.join(self.session_dir, "logs", "gcs.err"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.gcs_server",
             "--host", self.host, "--port", str(self._gcs_port),
             "--system-config", json.dumps(self._system_config),
             "--session-dir", self.session_dir,
             "--fate-share-pid",
             str(os.getpid() if self._fate_share else 0)],
            stdout=subprocess.PIPE, stderr=log, env=self._daemon_env(),
            start_new_session=True)
        port = _read_port(proc, "GCS_PORT=")
        self._procs.append(proc)
        self._gcs_proc = proc
        return (self.host, port)

    def kill_gcs(self) -> None:
        """Hard-kill the GCS process (fault-injection surface for
        control-plane bounce tests)."""
        self._gcs_proc.kill()
        self._gcs_proc.wait(timeout=10)

    def restart_gcs(self) -> Tuple[str, int]:
        """Restart the GCS on the SAME port, recovering its durable tables
        from the session snapshot (reference: GCS FT via external Redis +
        NotifyGCSRestart; here: file snapshot + raylet re-registration)."""
        if self._gcs_proc.poll() is None:
            self.kill_gcs()
        try:
            self._procs.remove(self._gcs_proc)
        except ValueError:
            pass
        self._gcs_port = self.gcs_addr[1]
        deadline = time.time() + 15
        last = None
        while time.time() < deadline:
            try:
                self.gcs_addr = self._start_gcs()
                return self.gcs_addr
            except RuntimeError as e:   # port briefly in TIME_WAIT
                last = e
                time.sleep(0.5)
        raise last

    def _start_raylet(self, object_store_memory) -> Tuple[str, int]:
        log = open(os.path.join(
            self.session_dir, "logs",
            f"raylet-{self.node_id.hex()[:12]}.err"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.raylet",
             "--host", self.host, "--port", "0",
             "--gcs-host", self.gcs_addr[0],
             "--gcs-port", str(self.gcs_addr[1]),
             "--node-id", self.node_id.hex(),
             "--resources", json.dumps(self.resources),
             "--labels", json.dumps(self.labels),
             "--session-dir", self.session_dir,
             "--object-store-capacity",
             str(object_store_memory or GlobalConfig.object_store_memory),
             "--fate-share-pid",
             str(os.getpid() if self._fate_share else 0)],
            stdout=subprocess.PIPE, stderr=log, env=self._daemon_env(),
            start_new_session=True)
        port = _read_port(proc, "RAYLET_PORT=")
        self._procs.append(proc)
        self._raylet_proc = proc
        return (self.host, port)

    def _start_dashboard(self) -> str:
        log = open(os.path.join(self.session_dir, "logs",
                                "dashboard.err"), "wb")
        env = self._daemon_env()
        # The head is a driver of the cluster (it submits jobs) and never
        # holds a card: no CUDA context can be made in it.
        env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.dashboard.head",
             "--host", self.host, "--port", "0",
             "--gcs-host", self.gcs_addr[0],
             "--gcs-port", str(self.gcs_addr[1]),
             "--session-dir", self.session_dir,
             "--fate-share-pid",
             str(os.getpid() if self._fate_share else 0)],
            stdout=subprocess.PIPE, stderr=log, env=env,
            start_new_session=True)
        port = _read_port(proc, "DASHBOARD_PORT=")
        self._procs.append(proc)
        return f"http://{self.host}:{port}"

    # --------------------------------------------------------------- teardown
    def kill_raylet(self):
        """Test hook: kill this node's raylet process (fault injection)."""
        self._raylet_proc.kill()

    def shutdown(self, cleanup_session: bool = True):
        import signal

        # SIGTERM first so the raylet can clean its /dev/shm store files...
        for proc in reversed(self._procs):
            if proc.poll() is None:
                try:
                    proc.terminate()
                except Exception:
                    pass
        deadline = time.monotonic() + 2.0
        for proc in self._procs:
            try:
                proc.wait(timeout=max(0.05, deadline - time.monotonic()))
            except Exception:
                pass
        # ...then SIGKILL the whole process group (workers included).
        for proc in reversed(self._procs):
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                if proc.poll() is None:
                    try:
                        proc.kill()
                    except Exception:
                        pass
        for proc in self._procs:
            try:
                proc.wait(timeout=3)
            except Exception:
                pass
        self._procs.clear()
        atexit.unregister(self.shutdown)
        if cleanup_session:
            shutil.rmtree(self.session_dir, ignore_errors=True)
