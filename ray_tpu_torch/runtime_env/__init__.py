"""Runtime environments — per-task/actor/job Python environments.

Role-equivalent to the reference's `python/ray/runtime_env/` +
`python/ray/_private/runtime_env/` (see its ARCHITECTURE.md): a runtime_env
is a declarative dict attached to a job, actor, or task; the raylet
materializes it on worker-pool miss (venvs, unpacked code packages) and
spawns the worker inside it. Environments are content-addressed (URIs), so
identical specs share one materialization, and unreferenced URIs are
garbage-collected from the node cache.

Supported fields (reference parity: `runtime_env.py` schema):

- ``env_vars``: {str: str} exported into the worker process.
- ``working_dir``: local directory (packaged + uploaded to the GCS so
  remote nodes can download it) or an existing ``gcs://`` package URI;
  workers start with cwd inside the unpacked copy.
- ``py_modules``: list of local module directories / ``.whl`` files /
  ``gcs://`` URIs, prepended to the worker's PYTHONPATH.
- ``pip``: list of requirement strings (or {"packages": [...]} dict, or a
  path to a requirements.txt). Materialized as a virtualenv keyed by the
  content hash; the worker runs under its interpreter. Built with
  ``--system-site-packages`` so the host's preinstalled stack stays
  importable (and creation works offline for local wheel paths).
- ``conda``: not supported in this image (no conda binary) — raises at
  validation, matching the fail-fast behavior of the reference when the
  backing tool is missing.
- ``container``: {"image": ..., "run_options": [...]}: the worker runs as
  ``$RAY_TPU_CONTAINER_RUNTIME run --rm --network=host -v /tmp:/tmp
  <run_options> -e K=V... <image> python3 -m
  ray_tpu_torch._private.worker_main ...`` (fails fast when the variable
  names no runtime). The worker's env goes in through ``-e`` flags, with
  ``CUDA_VISIBLE_DEVICES`` naming the cards of its lease (none without a
  GPU lease); exposing the card's device files to the container is the
  user's ``run_options`` (e.g. ``["--gpus", "all"]``).
- ``config``: {"setup_timeout_seconds": int, "eager_install": bool}.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip", "conda",
              "container", "config", "excludes"}


class RuntimeEnvValidationError(ValueError):
    pass


def validate_runtime_env(env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalize + validate a runtime_env dict (reference:
    `runtime_env.py` __init__ validation). Returns the normalized dict."""
    if not env:
        return {}
    if isinstance(env, RuntimeEnv):
        env = dict(env)
    if not isinstance(env, dict):
        raise RuntimeEnvValidationError(
            f"runtime_env must be a dict, got {type(env).__name__}")
    unknown = set(env) - _SUPPORTED
    if unknown:
        raise RuntimeEnvValidationError(
            f"unsupported runtime_env field(s) {sorted(unknown)}; "
            f"supported: {sorted(_SUPPORTED)}")
    out: Dict[str, Any] = {}
    if env.get("env_vars"):
        ev = env["env_vars"]
        if not isinstance(ev, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in ev.items()):
            raise RuntimeEnvValidationError(
                "env_vars must be a Dict[str, str]")
        out["env_vars"] = dict(ev)
    if env.get("working_dir") is not None:
        wd = env["working_dir"]
        if not isinstance(wd, str):
            raise RuntimeEnvValidationError("working_dir must be a str")
        if not wd.startswith("gcs://") and not os.path.isdir(wd):
            raise RuntimeEnvValidationError(
                f"working_dir {wd!r} is not a directory or gcs:// URI")
        out["working_dir"] = wd
    if env.get("py_modules") is not None:
        mods = env["py_modules"]
        if not isinstance(mods, (list, tuple)):
            raise RuntimeEnvValidationError("py_modules must be a list")
        for m in mods:
            if not isinstance(m, str):
                raise RuntimeEnvValidationError(
                    "py_modules entries must be str paths or gcs:// URIs")
            if (not m.startswith("gcs://") and not os.path.isdir(m)
                    and not (os.path.isfile(m) and m.endswith(".whl"))):
                raise RuntimeEnvValidationError(
                    f"py_modules entry {m!r} is not a module directory, "
                    ".whl file, or gcs:// URI")
        out["py_modules"] = list(mods)
    if env.get("pip") is not None:
        out["pip"] = _normalize_pip(env["pip"])
    if env.get("conda") is not None:
        raise RuntimeEnvValidationError(
            "runtime_env 'conda' is not supported in this build (no conda "
            "binary in the image); use 'pip' with wheel paths instead")
    if env.get("container") is not None:
        c = env["container"]
        if not isinstance(c, dict) or "image" not in c:
            raise RuntimeEnvValidationError(
                "container must be a dict with an 'image' key")
        if not os.environ.get("RAY_TPU_CONTAINER_RUNTIME"):
            raise RuntimeEnvValidationError(
                "runtime_env 'container' requires RAY_TPU_CONTAINER_RUNTIME "
                "to name a container runtime (e.g. podman) on every node")
        out["container"] = dict(c)
    if env.get("config"):
        out["config"] = dict(env["config"])
    if env.get("excludes"):
        out["excludes"] = list(env["excludes"])
    return out


def _normalize_pip(pip: Any) -> Dict[str, Any]:
    if isinstance(pip, str):
        # Path to a requirements.txt.
        if not os.path.isfile(pip):
            raise RuntimeEnvValidationError(
                f"pip requirements file {pip!r} not found")
        with open(pip) as f:
            packages = [line.strip() for line in f
                        if line.strip() and not line.startswith("#")]
        return {"packages": packages}
    if isinstance(pip, (list, tuple)):
        if not all(isinstance(p, str) for p in pip):
            raise RuntimeEnvValidationError("pip list entries must be str")
        return {"packages": list(pip)}
    if isinstance(pip, dict):
        if "packages" not in pip:
            raise RuntimeEnvValidationError(
                "pip dict form requires a 'packages' key")
        return {"packages": list(pip["packages"]),
                **{k: v for k, v in pip.items() if k != "packages"}}
    raise RuntimeEnvValidationError(
        f"pip must be a list, dict, or requirements path; got {type(pip)}")


class RuntimeEnv(dict):
    """Typed wrapper (reference: `ray.runtime_env.RuntimeEnv`). Behaves as
    the validated dict; construction validates eagerly."""

    def __init__(self, **kwargs):
        super().__init__(validate_runtime_env(kwargs))

    def to_dict(self) -> Dict[str, Any]:
        return dict(self)


__all__ = ["RuntimeEnv", "RuntimeEnvValidationError", "validate_runtime_env"]
