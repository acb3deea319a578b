"""Checkpoint storage over pyarrow filesystems.

Reference: `train/_internal/storage.py` (StorageContext) — experiment
artifacts live on a pyarrow `FileSystem`, so the same trainer code
persists to local disk, NFS, or object stores (`s3://`, `gs://`) without
path-specific branches. Multi-host TPU slices need this: every host
writes its checkpoint shard to one shared location.

URIs resolve via `pyarrow.fs.FileSystem.from_uri`; a plain path means the
local filesystem. An explicit `filesystem` argument (e.g. a mock or
fsspec-wrapped one) overrides URI inference — that is also how tests
exercise the remote path without real cloud credentials.
"""

from __future__ import annotations

import os
import posixpath
import shutil
from typing import Optional, Tuple


def resolve(path: str, filesystem=None) -> Tuple[object, str]:
    """(filesystem, fs_path) for a path/URI."""
    import pyarrow.fs as pafs

    if filesystem is not None:
        return filesystem, path
    if "://" in path:
        return pafs.FileSystem.from_uri(path)
    return pafs.LocalFileSystem(), os.path.abspath(path)


def is_uri(path: Optional[str]) -> bool:
    return bool(path) and "://" in path


class StorageContext:
    """One experiment's storage root on a pyarrow filesystem."""

    def __init__(self, storage_path: str, experiment_name: str = "",
                 filesystem=None):
        self.fs, root = resolve(storage_path, filesystem)
        self.root = (posixpath.join(root, experiment_name)
                     if experiment_name else root)
        # FileSystem.from_uri strips the scheme; keep the original URI so
        # checkpoint URIs stay restorable via Checkpoint.from_uri alone.
        base = storage_path if is_uri(storage_path) else None
        self._uri_root = (f"{base.rstrip('/')}/{experiment_name}"
                          if base and experiment_name else base)

    def uri_for(self, *parts: str) -> str:
        """Full URI (scheme included when one exists) for a storage
        entry; falls back to the fs path for explicit-filesystem use."""
        root = self._uri_root if self._uri_root else self.root
        return "/".join([root.rstrip("/"), *parts]) if parts else root

    # ----------------------------------------------------------------- paths
    def join(self, *parts: str) -> str:
        return posixpath.join(self.root, *parts)

    def makedirs(self, rel: str = "") -> None:
        self.fs.create_dir(self.join(rel) if rel else self.root,
                           recursive=True)

    def exists(self, rel: str) -> bool:
        import pyarrow.fs as pafs

        return self.fs.get_file_info(self.join(rel)).type \
            != pafs.FileType.NotFound

    def delete(self, rel: str) -> None:
        try:
            self.fs.delete_dir(self.join(rel))
        except (FileNotFoundError, OSError):
            pass

    # ------------------------------------------------------------- transfer
    def upload_dir(self, local_dir: str, rel: str) -> str:
        """Recursively copy a local directory into storage; returns the
        destination fs path."""
        dest_root = self.join(rel)
        self.fs.create_dir(dest_root, recursive=True)
        for dirpath, _dirnames, filenames in os.walk(local_dir):
            rel_dir = os.path.relpath(dirpath, local_dir)
            fs_dir = (dest_root if rel_dir == "."
                      else posixpath.join(dest_root, *rel_dir.split(os.sep)))
            if rel_dir != ".":
                self.fs.create_dir(fs_dir, recursive=True)
            for name in filenames:
                with open(os.path.join(dirpath, name), "rb") as src, \
                        self.fs.open_output_stream(
                            posixpath.join(fs_dir, name)) as dst:
                    shutil.copyfileobj(src, dst, 1 << 20)
        return dest_root


def download_dir(fs, fs_path: str, local_dir: str) -> str:
    """Recursively copy a storage directory to a local one."""
    import pyarrow.fs as pafs

    os.makedirs(local_dir, exist_ok=True)
    selector = pafs.FileSelector(fs_path, recursive=True)
    for info in fs.get_file_info(selector):
        rel = posixpath.relpath(info.path, fs_path)
        local = os.path.join(local_dir, *rel.split("/"))
        if info.type == pafs.FileType.Directory:
            os.makedirs(local, exist_ok=True)
        else:
            os.makedirs(os.path.dirname(local), exist_ok=True)
            with fs.open_input_stream(info.path) as src, \
                    open(local, "wb") as dst:
                shutil.copyfileobj(src, dst, 1 << 20)
    return local_dir
