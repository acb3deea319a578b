"""Checkpoint — a directory of files, with tensor-tree conveniences: the
port's copy of ``ray_tpu/train/checkpoint.py``.

Reference: `train/_checkpoint.py:56` (a directory on a pyarrow filesystem).
Here: a local/NFS directory path. Tree save/restore writes the leaves to a
flat numpy ``.npz`` and the structure, as plain containers, to a pickle, as
the reference does with a JAX treedef. A tree is nested dicts, lists and
tuples whose leaves are ``torch.Tensor``, numpy arrays or Python scalars.
A tensor whose dtype numpy lacks (bf16, the float8 types) is stored as its
raw bits, an unsigned integer view of the same width, with its torch dtype
recorded, so it round-trips bit for bit.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

_BITS = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16)}


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    try:
        return t.numpy()
    except TypeError:                       # no numpy dtype: keep the bits
        view, bits = _BITS[t.element_size()]
        return t.view(view).numpy().view(bits)


def _tensor_of(arr: np.ndarray, dtype: str,
               device: Optional[Union[str, torch.device]]) -> torch.Tensor:
    want = getattr(torch, dtype)
    if arr.dtype == np.uint16 and want != torch.uint16:
        arr = arr.view(np.int16)            # the bits of a bf16 tensor
    t = torch.from_numpy(arr)
    if t.dtype != want:
        t = t.view(want)
    return t if device is None else t.to(device)


def _flatten(tree: Any, leaves: List[np.ndarray]) -> Any:
    """The structure as plain containers, each leaf a ``("leaf", i, kind,
    dtype)`` record; the leaves' arrays appended to ``leaves``."""
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_flatten(v, leaves) for v in tree])
    if isinstance(tree, torch.Tensor):
        leaves.append(_numpy_of(tree))
        return ("leaf", len(leaves) - 1, "torch",
                str(tree.dtype).removeprefix("torch."))
    if isinstance(tree, np.ndarray):
        leaves.append(tree)
        return ("leaf", len(leaves) - 1, "numpy", None)
    if isinstance(tree, (bool, int, float)) or tree is None:
        return ("value", tree)
    raise TypeError(f"checkpoint trees hold dicts, lists, tuples, tensors, "
                    f"numpy arrays and scalars, not {type(tree).__name__}")


def _unflatten(node: Any, data, device) -> Any:
    kind = node[0]
    if kind == "dict":
        return {k: _unflatten(v, data, device) for k, v in node[1]}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, data, device) for v in node[1]]
        return items if kind == "list" else tuple(items)
    if kind == "value":
        return node[1]
    _, i, leaf_kind, dtype = node
    arr = data[str(i)]
    if leaf_kind == "numpy":
        return arr
    return _tensor_of(arr, dtype, device)


class Checkpoint:
    def __init__(self, path: Optional[str] = None, *,
                 uri: Optional[str] = None, filesystem=None):
        if path is None and uri is None:
            raise ValueError("Checkpoint needs a path or a uri")
        self._local_path = os.path.abspath(path) if path else None
        self.uri = uri
        self._fs = filesystem

    @property
    def path(self) -> str:
        """Local directory (lazily downloaded from storage when this
        checkpoint lives on a remote pyarrow filesystem)."""
        if self._local_path is None:
            from ray_tpu_torch.train.storage import download_dir, resolve

            fs, fs_path = resolve(self.uri, self._fs)
            local = tempfile.mkdtemp(prefix="rtpu-ckpt-dl-")
            download_dir(fs, fs_path, local)
            self._local_path = local
        return self._local_path

    # -- construction -------------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str, filesystem=None) -> "Checkpoint":
        """A checkpoint stored on a (possibly remote) pyarrow filesystem
        (reference: `Checkpoint.from_uri`)."""
        return cls(uri=uri, filesystem=filesystem)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rtpu-ckpt-")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    @classmethod
    def from_pytree(cls, tree: Any) -> "Checkpoint":
        """Save a tree of tensors (params, optimizer state) as npz +
        structure. Tensors on the card are copied to the host."""
        d = tempfile.mkdtemp(prefix="rtpu-ckpt-")
        leaves: List[np.ndarray] = []
        structure = _flatten(tree, leaves)
        np.savez(os.path.join(d, "arrays.npz"),
                 **{str(i): leaf for i, leaf in enumerate(leaves)})
        with open(os.path.join(d, "treedef.pkl"), "wb") as f:
            pickle.dump(structure, f)
        return cls(d)

    # -- reading ------------------------------------------------------------
    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            return self.path
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def as_directory(self):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            yield self.path

        return _ctx()

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def to_pytree(self, device: Optional[Union[str, torch.device]] = None
                  ) -> Any:
        """The saved tree; its tensors on ``device`` (default: the CPU,
        where they are read; name the card to load them onto it)."""
        with np.load(os.path.join(self.path, "arrays.npz")) as data:
            with open(os.path.join(self.path, "treedef.pkl"), "rb") as f:
                structure = pickle.load(f)
            return _unflatten(structure, data, device)

    # -- persistence --------------------------------------------------------
    def persist(self, storage_dir: str, name: Optional[str] = None) -> "Checkpoint":
        """Copy into experiment storage; returns the persisted checkpoint.

        Atomic: stage into a dot-prefixed tmp dir + rename, so a process
        killed mid-copy never leaves a torn `checkpoint_*` directory for
        crash recovery to pick up."""
        os.makedirs(storage_dir, exist_ok=True)
        dest = os.path.join(storage_dir,
                            name or f"checkpoint_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) == self.path:
            return Checkpoint(dest)
        tmp = os.path.join(storage_dir,
                           f".tmp_{os.path.basename(dest)}_{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(self.path, tmp)
        shutil.rmtree(dest, ignore_errors=True)  # relaunch overwrote name
        os.rename(tmp, dest)
        return Checkpoint(dest)

    def to_uri(self, uri: str, filesystem=None) -> "Checkpoint":
        """Upload into storage; returns the storage-backed checkpoint."""
        from ray_tpu_torch.train.storage import StorageContext

        storage = StorageContext(uri, filesystem=filesystem)
        storage.makedirs()
        storage.upload_dir(self.path, "")
        return Checkpoint(uri=uri, filesystem=filesystem)

    def __repr__(self):
        if self._local_path is None:
            return f"Checkpoint(uri={self.uri})"
        return f"Checkpoint({self._local_path})"
