"""Sharded checkpointing with resharding on restore: the port's counterpart
of ``ray_tpu/train/sharded_checkpoint.py``.

The reference saves a pjit-sharded train state as each host's addressable
shards and restores it onto another mesh shape. The port's sharded state
is a ``ZeroTrainState``: n virtual ranks on one device, rank r updating
its 1/n of the flat parameter vector with its own optimizer moments. A
checkpoint written at one n restores at any other.

Format (the reference's files; content kept dependency-free):

    <dir>/meta.pkl             structure + per-leaf global shape/dtype
    <dir>/shards-p{K}.npz      rank K's pieces: key "leaf{i}.s{j}" -> array
    <dir>/index-p{K}.pkl       key -> (leaf index, global slice tuple)

For a ``ZeroTrainState`` the leaves are the flat parameter vector and,
once a step has built the optimizer, AdamW's two moments over it (global
shape ``[size]``, without the ring's padding), plus the step counts in the
meta. Rank r writes the slices it owns: its shard of each (one piece per
overlap chunk; under the replicated update, rank 0 writes the whole
vector once). Restore: ``load_sharded`` builds the state on a
``RingGroup`` of any n and cuts each rank's slice, in the layout asked
for, out of whatever saved pieces overlap it, as the reference's
``make_array_from_callback`` assembler does.

A plain tree of tensors (a one-device ``TrainState``'s params) saves as
one piece per leaf and restores whole.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.train.checkpoint import (
    _flatten, _numpy_of, _tensor_of, _unflatten,
)

Span = Tuple[Tuple[int, int], ...]
_ZERO_LEAVES = ("params", "exp_avg", "exp_avg_sq")


def _spans(layout: Tuple, n: int, r: int,
           padded: int) -> List[Tuple[int, int]]:
    """Rank r's slices of the padded flat vector, one per optimizer
    tensor, in ``parallel.zero``'s layouts: chunk-major 1/n shards, or
    (replicated) the whole vector."""
    if layout[0] == "replicated":
        return [(0, padded)]
    out, off = [], 0
    for size in layout[1:]:
        cs = size // n
        out.append((off + r * cs, off + (r + 1) * cs))
        off += size
    return out


def _write(ckpt_dir: str, proc: int, pieces: Dict[str, np.ndarray],
           index: Dict[str, Tuple[int, Span]]) -> None:
    np.savez(os.path.join(ckpt_dir, f"shards-p{proc}.npz"), **pieces)
    with open(os.path.join(ckpt_dir, f"index-p{proc}.pkl"), "wb") as f:
        pickle.dump(index, f)


def save_sharded(tree: Any, ckpt_dir: str,
                 process_index: Optional[int] = None,
                 extra_meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the pieces of ``tree``: a ``ZeroTrainState`` (every rank's
    shard) or a plain tree of tensors (one piece per leaf, written by
    process 0; other processes' calls write an empty piece file)."""
    from ray_tpu_torch.parallel.zero import ZeroTrainState

    os.makedirs(ckpt_dir, exist_ok=True)
    if isinstance(tree, ZeroTrainState):
        _save_zero(tree, ckpt_dir, extra_meta or {})
        return
    proc = 0 if process_index is None else process_index
    leaves: List[np.ndarray] = []
    structure = _flatten(tree, leaves)
    pieces, index = {}, {}
    if proc == 0:
        for i, arr in enumerate(leaves):
            pieces[f"leaf{i}.s0"] = arr
            index[f"leaf{i}.s0"] = (i, tuple((0, d) for d in arr.shape))
    _write(ckpt_dir, proc, pieces, index)
    if proc == 0:
        with open(os.path.join(ckpt_dir, "meta.pkl"), "wb") as f:
            pickle.dump({"kind": "tree", "treedef": structure,
                         "leaves": [{"shape": a.shape, "dtype": a.dtype}
                                    for a in leaves],
                         "extra": extra_meta or {}}, f)


def _save_zero(state, ckpt_dir: str, extra: Dict[str, Any]) -> None:
    n, size = state.group.n, state.size
    padded = state.flat.shape[1]
    layout = state.layout or ("monolithic", padded)
    opt = state.optimizer
    names = _ZERO_LEAVES if opt is not None else _ZERO_LEAVES[:1]
    opt_step = None
    for r in range(n):
        pieces, index = {}, {}
        spans = [] if layout[0] == "replicated" and r else \
            _spans(layout, n, r, padded)
        for c, (a, b) in enumerate(spans):
            end = min(b, size)              # the ring's padding stays out
            if a >= end:
                continue
            values = [state.flat[r, a:end]]
            if opt is not None:
                st = opt.state[state.opt_params[r][c]]
                values += [st["exp_avg"][:end - a],
                           st["exp_avg_sq"][:end - a]]
                opt_step = float(st["step"])
            for i, t in enumerate(values):
                key = f"leaf{i}.s{c}"
                pieces[key] = _numpy_of(t)
                index[key] = (i, ((a, end),))
        _write(ckpt_dir, r, pieces, index)
    dtype = str(state.flat.dtype).removeprefix("torch.")
    with open(os.path.join(ckpt_dir, "meta.pkl"), "wb") as f:
        pickle.dump({
            "kind": "zero", "names": names, "size": size,
            "torch_dtype": dtype, "step": state.step, "opt_step": opt_step,
            "spec": [(path, tuple(shape), off)
                     for path, shape, off in state.spec],
            "leaves": [{"shape": (size,),
                        "dtype": _numpy_of(state.flat[0, :1]).dtype}
                       for _ in names],
            "extra": extra}, f)


def load_meta(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, "meta.pkl"), "rb") as f:
        return pickle.load(f)


class _PieceReader:
    """All saved pieces of one checkpoint, opened per rank file."""

    def __init__(self, ckpt_dir: str):
        self._stores = []
        for idx_path in sorted(glob.glob(
                os.path.join(ckpt_dir, "index-p*.pkl"))):
            proc = os.path.basename(idx_path)[len("index-p"):-len(".pkl")]
            with open(idx_path, "rb") as f:
                index = pickle.load(f)
            npz = np.load(os.path.join(ckpt_dir, f"shards-p{proc}.npz"))
            self._stores.append((index, npz))
        # leaf -> [(span, store, key)]
        self._by_leaf: Dict[int, list] = {}
        for index, npz in self._stores:
            for key, (leaf_i, span) in index.items():
                self._by_leaf.setdefault(leaf_i, []).append((span, npz, key))

    def read_slice(self, leaf_i: int, span: Span, dtype) -> np.ndarray:
        """Assemble the requested global slice from overlapping pieces."""
        out = np.empty([b - a for a, b in span], dtype=dtype)
        filled = 0
        for piece_span, npz, key in self._by_leaf.get(leaf_i, []):
            inter = []
            for (ra, rb), (pa, pb) in zip(span, piece_span):
                a, b = max(ra, pa), min(rb, pb)
                if a >= b:
                    inter = None
                    break
                inter.append((a, b))
            if inter is None:
                continue
            data = npz[key]
            src = tuple(slice(a - pa, b - pa)
                        for (a, b), (pa, _pb) in zip(inter, piece_span))
            dst = tuple(slice(a - ra, b - ra)
                        for (a, b), (ra, _rb) in zip(inter, span))
            out[dst] = data[src]
            filled += int(np.prod([b - a for a, b in inter]))
        if filled < out.size:
            raise ValueError(
                f"checkpoint is missing data for leaf {leaf_i} slice {span} "
                f"({filled}/{out.size} elements found) — were all ranks' "
                "shard files written into the checkpoint directory?")
        return out

    def close(self) -> None:
        for _, npz in self._stores:
            npz.close()


def load_sharded(ckpt_dir: str, group=None, optimizer=None, *,
                 overlap: bool = False, n_chunks: int = 4,
                 replicated: bool = False,
                 device: Optional[Union[str, torch.device]] = None) -> Any:
    """Restore what ``save_sharded`` wrote.

    A ``ZeroTrainState`` restores onto ``group`` (a ``RingGroup`` of any
    n, on its device) with ``optimizer``, the factory its steps will be
    given: every rank's copy of the params, and, if the saved state had
    its optimizer, the optimizer in the layout of the step that will
    continue it (``overlap``/``n_chunks`` as ``build_zero_train_step``
    takes them, or ``replicated`` for ``build_replicated_train_step``),
    each rank's moments cut from the saved pieces. A plain tree restores
    whole, its tensors on ``device`` (default: the CPU)."""
    meta = load_meta(ckpt_dir)
    reader = _PieceReader(ckpt_dir)
    try:
        if meta["kind"] == "tree":
            data = {str(i): reader.read_slice(
                        i, tuple((0, d) for d in info["shape"]),
                        info["dtype"])
                    for i, info in enumerate(meta["leaves"])}
            return _unflatten(meta["treedef"], data, device)
        if group is None or optimizer is None:
            raise ValueError("a ZeroTrainState restores onto a RingGroup "
                             "with its optimizer factory: pass group= and "
                             "optimizer=")
        return _load_zero(meta, reader, group, optimizer,
                          overlap=overlap, n_chunks=n_chunks,
                          replicated=replicated)
    finally:
        reader.close()


def _load_zero(meta, reader: _PieceReader, group, optimizer, *,
               overlap: bool, n_chunks: int, replicated: bool):
    from ray_tpu_torch.parallel.zero import (
        ZeroTrainState, _build_optimizer, _chunks, _padded_len,
    )

    n, size, dev = group.n, meta["size"], group.device
    dtype = meta["torch_dtype"]
    padded = _padded_len(size, n)

    def read(i: int, a: int, b: int) -> torch.Tensor:
        """Leaf i's global [a, b) on the device; zero past ``size``."""
        out = torch.zeros(b - a, dtype=getattr(torch, dtype), device=dev)
        end = min(b, size)
        if a < end:
            arr = reader.read_slice(i, ((a, end),),
                                    meta["leaves"][i]["dtype"])
            out[:end - a] = _tensor_of(arr, dtype, dev)
        return out

    params = read(0, 0, size)
    flat = torch.zeros((n, padded), dtype=params.dtype, device=dev)
    flat[:, :size] = params
    state = ZeroTrainState(
        flat=flat, group=group, make_optimizer=optimizer,
        spec=[(path, torch.Size(shape), off)
              for path, shape, off in meta["spec"]],
        size=size, step=meta["step"])
    if meta["opt_step"] is None:
        return state                    # the first step builds it
    if replicated:
        layout: Tuple = ("replicated",)
    elif overlap:
        layout = ("overlap", *_chunks(padded, n, n_chunks))
    else:
        layout = ("monolithic", padded)
    _build_optimizer(state, layout, optimizer)
    for r in range(n):
        for c, (a, b) in enumerate(_spans(layout, n, r, padded)):
            state.optimizer.state[state.opt_params[r][c]] = {
                "step": torch.tensor(meta["opt_step"], dtype=torch.float32),
                "exp_avg": read(1, a, b), "exp_avg_sq": read(2, a, b)}
    return state
