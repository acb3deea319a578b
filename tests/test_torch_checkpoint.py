"""The port's checkpoints: ``train/checkpoint.py`` (tensor trees through
npz, bf16 as its raw bits), ``train/storage.py`` (pyarrow filesystems,
``tests/test_storage.py``'s cases) and ``train/sharded_checkpoint.py``
(a ``ZeroTrainState`` saved at one ring size and restored at another).

ZeRO states here train a small linear model: two CPU runs of a Llama's
gradients are not always bit-identical, and the restore is held bit for
bit.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.train import Checkpoint  # noqa: E402
from ray_tpu_torch.train.sharded_checkpoint import (  # noqa: E402
    load_meta, load_sharded, save_sharded,
)


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else (
        t.view(torch.int32) if t.element_size() == 4 else t.view(torch.uint8))


def _tree(gen):
    return {
        "params": {"w": torch.randn(4, 8, generator=gen).bfloat16(),
                   "b": torch.randn(8, generator=gen)},
        "moments": [torch.randn(3, generator=gen).bfloat16(),
                    (torch.randn(2, 2, generator=gen), np.arange(5))],
        "step": 7, "lr": 1e-3, "note": None,
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert got == want and type(got) is type(want)


# ------------------------------------------------------------ checkpoint

def test_pytree_round_trips_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    tree = _tree(gen)
    # Values bf16 rounds differently from f32's: NaN payloads, -0, tiny.
    tree["params"]["w"][0, :4] = torch.tensor(
        [float("nan"), -0.0, 1e-40, float("inf")]).bfloat16()
    back = Checkpoint.from_pytree(tree).to_pytree()
    _assert_same(back, tree)
    assert back["params"]["w"].device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2",
                                   "float16", "int8", "bool"])
def test_dtypes_numpy_lacks_or_has_round_trip(dtype):
    if not hasattr(torch, dtype):
        pytest.skip(f"torch {torch.__version__} has no {dtype}")
    dt = getattr(torch, dtype)
    x = torch.randn(16) * 4
    t = x.to(dt) if dt is not torch.bool else x > 0
    back = Checkpoint.from_pytree({"t": t}).to_pytree()["t"]
    assert back.dtype == dt
    assert torch.equal(back.view(torch.uint8) if back.element_size() == 1
                       else back, t.view(torch.uint8)
                       if t.element_size() == 1 else t)


def test_to_pytree_onto_a_device():
    tree = {"w": torch.arange(6, dtype=torch.bfloat16)}
    back = Checkpoint.from_pytree(tree).to_pytree(device="cpu")
    assert back["w"].device == torch.device("cpu")
    assert torch.equal(back["w"], tree["w"])


def test_grad_leaves_are_detached():
    w = torch.ones(3, requires_grad=True)
    back = Checkpoint.from_pytree({"w": w * 2}).to_pytree()
    assert not back["w"].requires_grad
    assert torch.equal(back["w"], torch.full((3,), 2.0))


def test_unsupported_leaf_raises():
    with pytest.raises(TypeError, match="checkpoint trees hold"):
        Checkpoint.from_pytree({"f": object()})


def test_dict_persist_and_directory(tmp_path):
    ckpt = Checkpoint.from_dict({"epoch": 3, "tag": "x"})
    kept = ckpt.persist(str(tmp_path / "store"), name="checkpoint_000001")
    assert kept.path == str(tmp_path / "store" / "checkpoint_000001")
    assert not [d for d in os.listdir(tmp_path / "store")
                if d.startswith(".tmp")]
    assert Checkpoint.from_directory(kept.path).to_dict() == {
        "epoch": 3, "tag": "x"}
    with kept.as_directory() as d:
        assert os.path.exists(os.path.join(d, "data.pkl"))
    copy = kept.to_directory(str(tmp_path / "copy"))
    assert Checkpoint(copy).to_dict()["epoch"] == 3
    with pytest.raises(ValueError, match="path or a uri"):
        Checkpoint()


# --------------------------------------------------------------- storage

def _mock_fs():
    import pyarrow.fs as pafs

    return pafs._MockFileSystem()


class TestStorageContext:
    def test_upload_download_roundtrip(self, tmp_path):
        from ray_tpu_torch.train.storage import StorageContext, download_dir

        src = tmp_path / "src"
        (src / "sub").mkdir(parents=True)
        (src / "a.txt").write_text("alpha")
        (src / "sub" / "b.bin").write_bytes(b"\x00\x01\x02")

        fs = _mock_fs()
        storage = StorageContext("exp", "trial1", filesystem=fs)
        storage.makedirs()
        storage.upload_dir(str(src), "ckpt_0")
        assert storage.exists("ckpt_0")
        assert storage.exists("ckpt_0/a.txt")

        dest = tmp_path / "dest"
        download_dir(fs, storage.join("ckpt_0"), str(dest))
        assert (dest / "a.txt").read_text() == "alpha"
        assert (dest / "sub" / "b.bin").read_bytes() == b"\x00\x01\x02"

        storage.delete("ckpt_0")
        assert not storage.exists("ckpt_0")

    def test_local_uri(self, tmp_path):
        from ray_tpu_torch.train.storage import StorageContext

        src = tmp_path / "data"
        src.mkdir()
        (src / "x").write_text("1")
        storage = StorageContext(f"file://{tmp_path}/store", "run")
        storage.makedirs()
        storage.upload_dir(str(src), "c")
        assert (tmp_path / "store" / "run" / "c" / "x").read_text() == "1"
        assert storage.uri_for("c") == f"file://{tmp_path}/store/run/c"


def test_pytree_roundtrip_through_mock_fs():
    fs = _mock_fs()
    tree = {"w": torch.arange(6.0).reshape(2, 3).bfloat16(), "step": 7}
    ckpt = Checkpoint.from_pytree(tree)
    remote = ckpt.to_uri("bucket/ckpts/c1", filesystem=fs)
    assert remote.uri == "bucket/ckpts/c1"
    # Fresh object: downloads lazily on first .path access.
    back = Checkpoint.from_uri("bucket/ckpts/c1", filesystem=fs)
    _assert_same(back.to_pytree(), tree)


# ------------------------------------------------------ sharded: ZeRO

def _zero(n, dtype=torch.float32, steps=2, overlap=False, replicated=False,
          seed=0):
    """A ZeroTrainState at n ranks after ``steps`` AdamW steps of a small
    linear model, its step function, its optimizer factory and batch."""
    from ray_tpu_torch.parallel import (
        build_replicated_train_step, build_zero_train_step,
        create_zero_state,
    )
    from ray_tpu_torch.util.collective import RingGroup

    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(50, 9, generator=gen).to(dtype),
              "head": {"b": torch.randn(9, generator=gen).to(dtype),
                       "v": torch.randn(300, generator=gen).to(dtype)}}
    batch = {"x": torch.randn(8, 50, generator=gen).to(dtype)}
    opt = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4)

    def loss(p, b):
        y = b["x"] @ p["w"] + p["head"]["b"]
        return (y.float() ** 2).mean() + (p["head"]["v"].float() ** 2).sum()

    group = RingGroup(n, "cpu")
    state = create_zero_state(params, opt, group)
    if replicated:
        step = build_replicated_train_step(loss, opt, group)
    else:
        step = build_zero_train_step(loss, opt, group, overlap=overlap,
                                     n_chunks=2)
    for _ in range(steps):
        state, _ = step(state, batch)
    return state, step, opt, batch, loss


def _global(state, key):
    """A moment over the unpadded flat vector, from every rank's slices."""
    from ray_tpu_torch.train.sharded_checkpoint import _spans

    out = torch.zeros(state.flat.shape[1], dtype=state.flat.dtype)
    for r in range(state.group.n):
        for c, (a, b) in enumerate(_spans(state.layout, state.group.n, r,
                                             state.flat.shape[1])):
            out[a:b] = state.optimizer.state[state.opt_params[r][c]][key]
    return out[:state.size]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [4, 2, 1])
def test_zero_state_saved_at_4_restores_at_n(tmp_path, n, dtype):
    from ray_tpu_torch.util.collective import RingGroup

    state, _, opt, _, _ = _zero(4, dtype)
    save_sharded(state, str(tmp_path))
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("shards")) \
        == [f"shards-p{r}.npz" for r in range(4)]
    back = load_sharded(str(tmp_path), RingGroup(n, "cpu"), opt)
    assert back.group.n == n and back.step == state.step == 2
    assert back.flat.dtype == dtype and back.size == state.size
    for r in range(n):
        assert torch.equal(_bits(back.flat[r, :back.size]),
                           _bits(state.flat[0, :state.size]))
        assert not back.flat[r, back.size:].any()
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(_bits(_global(back, key)),
                           _bits(_global(state, key)))
    steps = {float(back.optimizer.state[p]["step"])
             for row in back.opt_params for p in row}
    assert steps == {2.0}
    for path, shape, off in back.spec:
        leaf = back.rank_params(n - 1)
        for k in path:
            leaf = leaf[k]
        assert leaf.shape == shape


def test_step_after_restore_equals_a_step_without_it(tmp_path):
    from ray_tpu_torch.parallel import build_zero_train_step
    from ray_tpu_torch.util.collective import RingGroup

    state, step, opt, batch, loss = _zero(4)
    save_sharded(state, str(tmp_path))
    group = RingGroup(4, "cpu")
    back = load_sharded(str(tmp_path), group, opt)
    back, m_back = build_zero_train_step(loss, opt, group)(back, batch)
    state, m = step(state, batch)
    assert torch.equal(back.flat, state.flat)
    assert torch.equal(m_back["loss"], m["loss"])
    assert m_back["step"] == m["step"] == 3
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(_global(back, key), _global(state, key))


def test_overlap_layout_saves_per_chunk_and_reshards(tmp_path):
    """An overlap state's shards are chunk-major (a piece per chunk per
    rank); it restores at another n in the layout asked for, and a
    monolithic one restores into the overlap layout."""
    from ray_tpu_torch.util.collective import RingGroup

    state, _, opt, _, _ = _zero(4, overlap=True)
    assert state.layout[0] == "overlap" and len(state.layout) == 3
    save_sharded(state, str(tmp_path / "o"))
    for n, overlap in ((2, True), (2, False), (1, True)):
        back = load_sharded(str(tmp_path / "o"), RingGroup(n, "cpu"), opt,
                            overlap=overlap, n_chunks=2)
        assert back.layout[0] == ("overlap" if overlap else "monolithic")
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(_global(back, key), _global(state, key))
    mono, _, opt, _, _ = _zero(4)
    save_sharded(mono, str(tmp_path / "m"))
    back = load_sharded(str(tmp_path / "m"), RingGroup(4, "cpu"), opt,
                        overlap=True, n_chunks=2)
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(_global(back, key), _global(mono, key))


def test_replicated_layout_writes_one_copy(tmp_path):
    from ray_tpu_torch.util.collective import RingGroup

    state, _, opt, _, _ = _zero(2, replicated=True)
    save_sharded(state, str(tmp_path))
    sizes = [os.path.getsize(tmp_path / f"shards-p{r}.npz")
             for r in range(2)]
    assert sizes[0] > 10 * sizes[1]             # rank 1 wrote no piece
    back = load_sharded(str(tmp_path), RingGroup(4, "cpu"), opt)
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(_global(back, key), _global(state, key))
    back = load_sharded(str(tmp_path), RingGroup(3, "cpu"), opt,
                        replicated=True)
    assert back.layout[0] == "replicated"
    for r in range(3):
        m = back.optimizer.state[back.opt_params[r][0]]["exp_avg"]
        assert torch.equal(m[:state.size], _global(state, "exp_avg"))


def test_state_before_its_first_step_saves_params_only(tmp_path):
    from ray_tpu_torch.util.collective import RingGroup

    state, _, opt, _, _ = _zero(4, steps=0)
    save_sharded(state, str(tmp_path))
    assert load_meta(str(tmp_path))["names"] == ("params",)
    back = load_sharded(str(tmp_path), RingGroup(2, "cpu"), opt)
    assert back.optimizer is None and back.step == 0
    assert torch.equal(back.flat[1, :back.size], state.flat[0, :state.size])


def test_zero_restore_needs_group_and_optimizer(tmp_path):
    state, _, _, _, _ = _zero(2, steps=1)
    save_sharded(state, str(tmp_path))
    with pytest.raises(ValueError, match="group= and optimizer="):
        load_sharded(str(tmp_path))


def test_missing_rank_file_raises(tmp_path):
    from ray_tpu_torch.util.collective import RingGroup

    state, _, opt, _, _ = _zero(4)
    save_sharded(state, str(tmp_path))
    os.remove(tmp_path / "index-p1.pkl")
    with pytest.raises(ValueError, match="missing data"):
        load_sharded(str(tmp_path), RingGroup(2, "cpu"), opt)


# ------------------------------------------------- sharded: plain trees

def test_plain_tree_saves_as_one_piece_per_leaf(tmp_path):
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    params = init_params(LlamaConfig.tiny(param_dtype=torch.bfloat16),
                         seed=0, device="cpu")
    save_sharded(params, str(tmp_path), extra_meta={"step": 5})
    meta = load_meta(str(tmp_path))
    assert meta["kind"] == "tree" and meta["extra"] == {"step": 5}
    assert os.listdir(tmp_path).count("shards-p0.npz") == 1
    back = load_sharded(str(tmp_path))
    _assert_same(back, params)
    # Another process's call writes no piece and no meta.
    save_sharded(params, str(tmp_path / "p1"), process_index=1)
    assert sorted(os.listdir(tmp_path / "p1")) == ["index-p1.pkl",
                                                   "shards-p1.npz"]
