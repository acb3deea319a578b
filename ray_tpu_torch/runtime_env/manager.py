"""Node-side runtime_env materialization + URI cache with GC.

Role-equivalent to the reference's runtime_env agent
(`_private/runtime_env/agent/runtime_env_agent.py` + plugins `pip.py`,
`working_dir.py`, `py_modules.py`, `container.py`): the raylet asks this
manager to materialize a validated runtime_env before spawning a worker
into it. Each resource is content-addressed:

- pip venvs live under ``<base>/pip/<hash-of-packages>``
- packages (working_dir / py_modules) under ``<base>/pkg/<uri-hash>``

Reference counts track which URIs live workers use; unreferenced entries
are deleted once the cache exceeds its size budget (reference:
`runtime_env/agent` URI cache GC, RAY_RUNTIME_ENV_*_CACHE_SIZE_GB).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.runtime_env import packaging


class RuntimeEnvSetupError(RuntimeError):
    pass


class RuntimeEnvContext:
    """What the raylet needs to spawn a worker inside the env."""

    __slots__ = ("env_vars", "py_executable", "pythonpath", "working_dir",
                 "command_prefix", "uris")

    def __init__(self):
        self.env_vars: Dict[str, str] = {}
        self.py_executable: Optional[str] = None
        self.pythonpath: List[str] = []
        self.working_dir: Optional[str] = None
        # ``<runtime> run ... <image>`` for a container env: the raylet
        # puts the worker's env in -e flags before the image.
        self.command_prefix: List[str] = []
        self.uris: List[str] = []   # cache keys this context references


class RuntimeEnvManager:
    def __init__(self, base_dir: str, gcs_client,
                 cache_size_bytes: int = 10 * 1024 * 1024 * 1024):
        self._base = base_dir
        self._gcs = gcs_client
        self._cache_cap = cache_size_bytes
        self._locks: Dict[str, asyncio.Lock] = {}
        self._refs: Dict[str, int] = {}       # uri -> live worker count
        self._last_used: Dict[str, float] = {}
        self._sizes: Dict[str, int] = {}
        self.creations = 0                    # observability: cache misses
        self._create_s: Dict[str, float] = {}  # uri -> seconds to create it
        os.makedirs(os.path.join(base_dir, "pip"), exist_ok=True)
        os.makedirs(os.path.join(base_dir, "pkg"), exist_ok=True)

    # ---- public -----------------------------------------------------------
    async def setup(self, runtime_env: Dict[str, Any]) -> RuntimeEnvContext:
        """Materialize every resource of a validated runtime_env. Safe to
        call concurrently; each URI is created once (per-URI lock)."""
        from ray_tpu_torch.runtime_env import validate_runtime_env

        # Validation reads requirements files off disk: keep it (and the
        # packaging below) off the event loop.
        runtime_env = await asyncio.get_running_loop().run_in_executor(
            None, validate_runtime_env, runtime_env)
        ctx = RuntimeEnvContext()
        timeout = (runtime_env.get("config") or {}).get(
            "setup_timeout_seconds", 600)
        try:
            await asyncio.wait_for(self._setup_inner(runtime_env, ctx),
                                   timeout)
        except asyncio.TimeoutError:
            raise RuntimeEnvSetupError(
                f"runtime_env setup exceeded {timeout}s") from None
        # The bare ref/recency writes here and in release()/_maybe_gc()
        # are safe: everything runs on the raylet's one event loop with
        # no await between read and write. The per-URI asyncio.Lock in
        # _ensure_package dedups *creation work*, it is not a data lock.
        for uri in ctx.uris:
            self._refs[uri] = self._refs.get(uri, 0) + 1
            self._last_used[uri] = time.monotonic()  # graftlint: disable=lockset-consistency (single event loop; see above)
        return ctx

    def release(self, uris: List[str]) -> None:
        """A worker using these URIs exited."""
        for uri in uris:
            self._refs[uri] = max(0, self._refs.get(uri, 0) - 1)
            self._last_used[uri] = time.monotonic()  # graftlint: disable=lockset-consistency (single event loop; see setup)
        self._maybe_gc()

    def stats(self) -> Dict[str, Any]:
        return {"creations": self.creations,
                "cached_uris": sorted(self._refs),
                "refs": dict(self._refs),
                "cache_bytes": sum(self._sizes.values()),
                "create_seconds": dict(self._create_s)}

    # ---- internals --------------------------------------------------------
    def _lock(self, key: str) -> asyncio.Lock:
        lock = self._locks.get(key)
        if lock is None:
            lock = self._locks[key] = asyncio.Lock()
        return lock

    async def _setup_inner(self, runtime_env: Dict[str, Any],
                           ctx: RuntimeEnvContext) -> None:
        ctx.env_vars.update(runtime_env.get("env_vars") or {})

        wd = runtime_env.get("working_dir")
        if wd:
            if packaging.is_package_uri(wd):
                ctx.working_dir = await self._ensure_package(wd)
            else:
                # Same-node fast path: the driver's local dir is directly
                # visible; remote nodes receive the packaged URI instead
                # (rewritten at submission, see prepare_runtime_env).
                ctx.working_dir = os.path.abspath(wd)
            if ctx.working_dir:
                ctx.uris.append(f"wd:{ctx.working_dir}")
                ctx.pythonpath.append(ctx.working_dir)

        for mod in runtime_env.get("py_modules") or []:
            if packaging.is_package_uri(mod):
                path = await self._ensure_package(mod)
                ctx.pythonpath.append(path)
                ctx.uris.append(mod)
            elif os.path.isdir(mod):
                # Prepend the PARENT so `import <dirname>` works.
                ctx.pythonpath.append(os.path.dirname(os.path.abspath(mod)))
            elif mod.endswith(".whl"):
                path = await self._ensure_wheel_unpacked(mod)
                ctx.pythonpath.append(path)

        pip = runtime_env.get("pip")
        if pip:
            venv = await self._ensure_pip_env(pip)
            ctx.py_executable = os.path.join(venv, "bin", "python")
            ctx.uris.append(f"pip:{os.path.basename(venv)}")

        container = runtime_env.get("container")
        if container:
            runtime = os.environ.get("RAY_TPU_CONTAINER_RUNTIME")
            if not runtime:
                raise RuntimeEnvSetupError(
                    "container runtime_env needs RAY_TPU_CONTAINER_RUNTIME")
            # The reference's prefix. A card reaches the container only
            # through the user's run_options (e.g. --gpus); which card the
            # lease names goes in as CUDA_VISIBLE_DEVICES (the raylet).
            ctx.command_prefix = (
                [runtime, "run", "--rm", "--network=host",
                 "-v", "/tmp:/tmp"]
                + list(container.get("run_options") or [])
                + [container["image"]])

    async def _ensure_package(self, uri: str) -> str:
        key = hashlib.sha256(uri.encode()).hexdigest()[:24]
        dest = os.path.join(self._base, "pkg", key)
        async with self._lock(uri):
            marker = os.path.join(dest, ".rtpu_pkg_ready")
            if os.path.exists(marker):
                self._last_used[uri] = time.monotonic()
                return self._package_root(dest)
            payload = await packaging.download_package(self._gcs, uri)
            loop = asyncio.get_running_loop()
            if uri.endswith(".whl") or "_whl_" in uri:
                await loop.run_in_executor(
                    None, self._unpack_wheel_bytes, payload, dest)
            else:
                await loop.run_in_executor(
                    None, packaging.unpack_package, payload, dest)
            self.creations += 1
            self._sizes[uri] = len(payload)
            # Stamp recency at creation. Without this a just-built
            # package has no _last_used entry, sorts as oldest in the
            # LRU, and _maybe_gc can delete it during the awaits between
            # here and setup() taking the ref.
            self._last_used[uri] = time.monotonic()
            return self._package_root(dest)

    @staticmethod
    def _package_root(dest: str) -> str:
        return dest

    @staticmethod
    def _unpack_wheel_bytes(payload: bytes, dest: str) -> None:
        import io
        import zipfile

        os.makedirs(dest, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(payload)) as zf:
            zf.extractall(dest)
        with open(os.path.join(dest, ".rtpu_pkg_ready"), "w") as f:
            f.write("ok")

    async def _ensure_wheel_unpacked(self, path: str) -> str:
        """Local .whl in py_modules: unpack (wheels are importable trees)."""
        loop = asyncio.get_running_loop()
        uri, payload = await loop.run_in_executor(
            None, packaging.package_wheel, path)
        key = hashlib.sha256(uri.encode()).hexdigest()[:24]
        dest = os.path.join(self._base, "pkg", key)
        async with self._lock(uri):
            if not os.path.exists(os.path.join(dest, ".rtpu_pkg_ready")):
                await loop.run_in_executor(
                    None, self._unpack_wheel_bytes, payload, dest)
                self.creations += 1
                self._sizes[uri] = len(payload)
        return dest

    async def _ensure_pip_env(self, pip: Dict[str, Any]) -> str:
        packages = pip["packages"]
        spec = json.dumps(packages, sort_keys=True)
        key = hashlib.sha256(spec.encode()).hexdigest()[:24]
        venv_dir = os.path.join(self._base, "pip", key)
        async with self._lock(f"pip:{key}"):
            marker = os.path.join(venv_dir, ".rtpu_env_ready")
            if os.path.exists(marker):
                return venv_dir
            loop = asyncio.get_running_loop()
            t0 = time.monotonic()
            try:
                await loop.run_in_executor(
                    None, self._create_venv, venv_dir, packages)
            except Exception:
                shutil.rmtree(venv_dir, ignore_errors=True)
                raise

            def _finish():
                # Marker write + recursive size walk are sync disk I/O:
                # keep them in the executor with the venv build, not on
                # the event loop this setup shares with the raylet.
                with open(marker, "w") as f:
                    f.write(spec)
                return _du(venv_dir)

            size = await loop.run_in_executor(None, _finish)
            self.creations += 1
            self._sizes[f"pip:{key}"] = size
            self._create_s[f"pip:{key}"] = time.monotonic() - t0
            return venv_dir

    def _create_venv(self, venv_dir: str, packages: List[str]) -> None:
        """venv inheriting the creating interpreter's packages: the host's
        preinstalled stack (torch built for CUDA, numpy, cloudpickle)
        stays importable and only the delta installs (reference: pip.py
        uses virtualenv the same way). --system-site-packages alone is
        not enough when the host python is itself a venv (as on the
        card's machine): the new venv would inherit the BASE interpreter's
        site-packages, so the current environment's package paths, and
        torch's wherever it lies, are grafted in with a .pth file.

        The venv is made without pip (no ensurepip run, the slow part of
        making a venv, which a system Python may lack); the creating
        interpreter's own pip installs into it (``--python``)."""
        import glob as _glob
        import importlib.util

        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages",
             "--without-pip", venv_dir],
            check=True, capture_output=True, timeout=300)
        parent_sites = [p for p in sys.path
                        if p.endswith("site-packages") and os.path.isdir(p)]
        spec = importlib.util.find_spec("torch")    # locates, no import
        if spec is not None and spec.origin:
            torch_root = os.path.dirname(os.path.dirname(spec.origin))
            if torch_root not in parent_sites:
                parent_sites.append(torch_root)
        for venv_site in _glob.glob(
                os.path.join(venv_dir, "lib", "python*", "site-packages")):
            with open(os.path.join(venv_site, "_rtpu_inherit.pth"),
                      "w") as f:
                f.write("\n".join(parent_sites) + "\n")
        cmd = [sys.executable, "-m", "pip", "--python",
               os.path.join(venv_dir, "bin", "python"), "install",
               "--no-input"]
        if all(os.path.exists(p.split("[")[0]) for p in packages):
            # Pure local wheels/dirs: never touch the network.
            cmd.append("--no-index")
        result = subprocess.run(cmd + list(packages),
                                capture_output=True, timeout=600)
        if result.returncode != 0:
            raise RuntimeEnvSetupError(
                f"pip install failed: {result.stderr.decode()[-2000:]}")

    # ---- GC ---------------------------------------------------------------
    def _maybe_gc(self) -> None:
        total = sum(self._sizes.values())
        if total <= self._cache_cap:
            return
        # Evict least-recently-used unreferenced entries. A URI whose
        # creation lock is held is mid-_ensure_package: its files are
        # about to be returned to a worker, so it is not a candidate
        # even though no ref exists yet.
        victims = sorted(
            (u for u in self._sizes
             if self._refs.get(u, 0) == 0
             and not self._creation_in_flight(u)),
            key=lambda u: self._last_used.get(u, 0))
        for uri in victims:
            if total <= self._cache_cap:
                break
            total -= self._sizes.pop(uri, 0)  # graftlint: disable=lockset-consistency (single event loop; see setup)
            self._refs.pop(uri, None)
            self._last_used.pop(uri, None)  # graftlint: disable=lockset-consistency (single event loop; see setup)
            self._create_s.pop(uri, None)
            self._delete_entry(uri)

    def _creation_in_flight(self, uri: str) -> bool:
        lock = self._locks.get(uri)
        return lock is not None and lock.locked()

    def _delete_entry(self, uri: str) -> None:
        if uri.startswith("pip:"):
            path = os.path.join(self._base, "pip", uri.split(":", 1)[1])
        elif uri.startswith("wd:"):
            return  # plain local dir — not ours to delete
        else:
            key = hashlib.sha256(uri.encode()).hexdigest()[:24]
            path = os.path.join(self._base, "pkg", key)
        shutil.rmtree(path, ignore_errors=True)


def _du(path: str) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


def prepare_runtime_env(runtime_env: Optional[Dict[str, Any]],
                        gcs_client) -> Optional[Dict[str, Any]]:
    """Driver-side submission rewrite (reference:
    `runtime_env.py` upload_*_if_needed): package local working_dir /
    py_modules dirs and replace them with gcs:// URIs so every node can
    materialize them."""
    from ray_tpu_torch.runtime_env import validate_runtime_env

    env = validate_runtime_env(runtime_env)
    if not env:
        return None
    wd = env.get("working_dir")
    if wd and not packaging.is_package_uri(wd):
        uri, payload = packaging.package_dir(wd, env.get("excludes"))
        packaging.upload_package(gcs_client, uri, payload)
        env["working_dir"] = uri
    mods = env.get("py_modules")
    if mods:
        out = []
        for m in mods:
            if packaging.is_package_uri(m):
                out.append(m)
            elif os.path.isdir(m):
                uri, payload = packaging.package_dir(
                    m, env.get("excludes"), include_root_name=True)
                packaging.upload_package(gcs_client, uri, payload)
                out.append(uri)
            elif m.endswith(".whl"):
                uri, payload = packaging.package_wheel(m)
                packaging.upload_package(gcs_client, uri, payload)
                out.append(uri)
        env["py_modules"] = out
    return env
