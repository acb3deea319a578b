"""Content-addressed code packages for runtime_env distribution.

Role-equivalent to the reference's `_private/runtime_env/packaging.py`:
a local ``working_dir`` / ``py_modules`` directory is zipped
deterministically, named by its content hash (``gcs://_rtpu_pkg_<sha>.zip``),
uploaded once to the GCS KV store, and downloaded + unpacked into each
node's cache on demand. Identical directory contents on any driver yield
the same URI, so re-submission reuses the cached package cluster-wide.
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import List, Optional

# Reference parity: packaging.py caps packages to protect the GCS
# (GCS_STORAGE_MAX_SIZE); ours rides the RPC frame, same concern.
MAX_PACKAGE_BYTES = 100 * 1024 * 1024

_KV_NAMESPACE = "runtime_env_pkg"

_DEFAULT_EXCLUDES = {"__pycache__", ".git", ".venv", "node_modules"}


def _iter_files(root: str, excludes: Optional[List[str]] = None):
    ex = _DEFAULT_EXCLUDES | set(excludes or [])
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ex)
        for name in sorted(filenames):
            if name in ex or name.endswith(".pyc"):
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            yield full, rel


def package_dir(root: str, excludes: Optional[List[str]] = None,
                include_root_name: bool = False) -> tuple:
    """Zip a directory deterministically; returns (uri, zip_bytes).

    ``include_root_name`` puts entries under ``<basename(root)>/...`` —
    used for py_modules so the unpacked tree is importable by its name
    (working_dir packages the contents directly, cwd IS the dir).
    """
    root = os.path.abspath(root)
    prefix = os.path.basename(root.rstrip(os.sep)) + "/" \
        if include_root_name else ""
    buf = io.BytesIO()
    hasher = hashlib.sha256()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for full, rel in _iter_files(root, excludes):
            with open(full, "rb") as f:
                data = f.read()
            hasher.update((prefix + rel).encode())
            hasher.update(data)
            # Fixed timestamp => byte-stable zip for identical content.
            info = zipfile.ZipInfo(prefix + rel,
                                   date_time=(2020, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
            zf.writestr(info, data)
    payload = buf.getvalue()
    if len(payload) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package for {root} is {len(payload)} bytes; "
            f"limit is {MAX_PACKAGE_BYTES} (use excludes or py_modules)")
    uri = f"gcs://_rtpu_pkg_{hasher.hexdigest()[:32]}.zip"
    return uri, payload


def package_wheel(path: str) -> tuple:
    """Content-address a single .whl file; returns (uri, bytes)."""
    with open(path, "rb") as f:
        payload = f.read()
    sha = hashlib.sha256(payload).hexdigest()[:32]
    uri = f"gcs://_rtpu_whl_{sha}_{os.path.basename(path)}"
    return uri, payload


def upload_package(gcs_client, uri: str, payload: bytes) -> None:
    """Idempotent upload into the GCS KV (driver side)."""
    if not gcs_client.call("kv_exists", namespace=_KV_NAMESPACE, key=uri,
                           timeout=30):
        gcs_client.call("kv_put", namespace=_KV_NAMESPACE, key=uri,
                        value=payload, overwrite=False, timeout=60)


async def download_package(gcs_aclient, uri: str) -> bytes:
    payload = await gcs_aclient.acall("kv_get", namespace=_KV_NAMESPACE,
                                      key=uri, timeout=60)
    if payload is None:
        raise FileNotFoundError(f"runtime_env package {uri} not in GCS")
    return payload


def unpack_package(payload: bytes, dest: str) -> str:
    """Extract a package zip into dest (idempotent via done-marker)."""
    marker = os.path.join(dest, ".rtpu_pkg_ready")
    if os.path.exists(marker):
        return dest
    os.makedirs(dest, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        zf.extractall(dest)
    with open(marker, "w") as f:
        f.write("ok")
    return dest


def is_package_uri(s: str) -> bool:
    return isinstance(s, str) and s.startswith("gcs://")
