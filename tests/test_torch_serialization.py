"""``torch.Tensor`` payloads in the port's object store
(``ray_tpu_torch/_private/serialization.py``).

Every dtype and layout round-trips bit for bit, alone and through a
cluster (this process and a worker); a large tensor's ``get`` lies over the
store's memory; a CUDA tensor payload raises in a getter without CUDA;
numpy payloads serialize to the reference's bytes exactly. On the card,
``chip_smoke.py``'s runtime phase puts a CUDA tensor and gets it back on
CUDA in a GPU actor.
"""

import ctypes
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch._private import serialization as S  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
          torch.int64, torch.bool]


def _tensor(dtype, shape=(6, 10), seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    return torch.randint(-100, 100, shape, generator=g).to(dtype)


LAYOUTS = {
    "contiguous": lambda t: t,
    "transposed": lambda t: t.t(),
    "strided_slice": lambda t: t[1::2, ::3],
    "offset_view": lambda t: t[2:, 4:],
    "zero_dim": lambda t: t[1, 2],
    "empty": lambda t: t[:0],
    "expanded": lambda t: t[:1].expand(4, -1),
}


def _bits(t):
    """The tensor's values as raw integers: bit-for-bit comparison (NaN
    and -0.0 included)."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def _same(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _roundtrip(value):
    ctx = S.SerializationContext()
    return ctx.deserialize(memoryview(ctx.serialize(value).to_bytes()))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_roundtrip_bit_for_bit(dtype, layout):
    want = LAYOUTS[layout](_tensor(dtype))
    got = _roundtrip({"t": want, "n": 1})
    _same(got["t"], want)
    assert got["t"].stride() == want.stride() or want.numel() == 0


def test_one_out_of_band_buffer_per_tensor_spanning_the_view():
    base = _tensor(torch.bfloat16, (64, 64))
    view = base[8:16, ::2]
    sobj = S.SerializationContext().serialize([view, base])
    assert [b.nbytes for b in sobj.buffers] == [
        2 * (1 + 7 * 64 + 31 * 2), base.numel() * 2]


def test_nan_and_negative_zero_keep_their_bits():
    want = torch.tensor([float("nan"), -0.0, float("inf"), 1e-45],
                        dtype=torch.float32)
    _same(_roundtrip(want), want)


def test_requires_grad_survives():
    want = _tensor(torch.float32).requires_grad_(True)
    got = _roundtrip(want)
    assert got.requires_grad and got.is_leaf
    _same(got.detach(), want.detach())


def test_numpy_payload_has_the_reference_bytes():
    from ray_tpu._private import serialization as R

    rng = np.random.RandomState(0)
    value = {"a": rng.randn(64, 33).astype(np.float32),
             "b": rng.randint(0, 9, (7,)).astype(np.int64)[::2],
             "c": [1, "x", 2.5]}
    port = S.SerializationContext().serialize(value).to_bytes()
    ref = R.SerializationContext().serialize(value).to_bytes()
    assert port == ref


def test_cuda_payload_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the getter can take it")
    payload = (S._rebuild_tensor, (np.zeros(16, np.uint8),
                                   "torch.float32", (4,), (1,), "cuda",
                                   False))

    class CudaPayload:
        def __reduce__(self):
            return payload

    data = memoryview(S.SerializationContext().serialize(
        CudaPayload()).to_bytes())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.SerializationContext().deserialize(data)


def test_serializer_imports_no_torch_for_plain_values():
    code = ("import sys, numpy as np; "
            "from ray_tpu_torch._private.serialization import "
            "SerializationContext as C; c = C(); "
            "c.deserialize(memoryview(c.serialize({'a': np.ones(3)})"
            ".to_bytes())); print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ------------------------------------------------------- through a cluster

@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu_torch.init(num_cpus=2, num_gpus=0,
                              object_store_memory=256 * 1024 * 1024,
                              ignore_reinit_error=True)
    yield info
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def echo(x):
    return x


@ray_tpu_torch.remote
def checksum(ts):
    return [int(_bits(t).to(torch.int64).sum()) for t in ts]


def test_store_roundtrip_every_dtype_and_layout(cluster):
    tensors = [LAYOUTS[layout](_tensor(dtype, (64, 96), seed=i))
               for i, (dtype, layout) in enumerate(
                   (d, lay) for d in DTYPES for lay in sorted(LAYOUTS))]
    for got, want in zip(ray_tpu_torch.get(ray_tpu_torch.put(tensors),
                                           timeout=60), tensors):
        _same(got, want)
    # Through a worker: the task reads them and returns them.
    back = ray_tpu_torch.get(echo.remote(tensors), timeout=120)
    for got, want in zip(back, tensors):
        _same(got, want)
    assert ray_tpu_torch.get(checksum.remote(tensors), timeout=120) == [
        int(_bits(t).to(torch.int64).sum()) for t in tensors]


def _arena_ranges():
    from ray_tpu_torch._private import object_store

    out = []
    for m in object_store._client_arenas.values():
        base = ctypes.addressof(ctypes.c_char.from_buffer(m))
        out.append((base, base + len(m)))
    return out


def test_large_get_shares_the_store_memory(cluster):
    want = _tensor(torch.bfloat16, (4096, 8192))          # 64 MiB
    assert want.numel() * want.element_size() == 64 << 20
    got = ray_tpu_torch.get(ray_tpu_torch.put(want), timeout=60)
    _same(got, want)
    ptr = got.data_ptr()
    assert any(lo <= ptr and ptr + (64 << 20) <= hi
               for lo, hi in _arena_ranges()), "the tensor was copied"
    again = ray_tpu_torch.get(ray_tpu_torch.put(want[:, :4096].t()),
                              timeout=60)
    _same(again, want[:, :4096].t())
    assert pickle.loads(pickle.dumps(again)).shape == (4096, 4096)


def test_gotten_tensors_alias_the_stored_object(cluster):
    """The contract of a zero-copy ``get``: the tensor is a view of the
    sealed object, so an in-place write through it changes what every
    later ``get`` on the node reads, in this process and in a worker.
    A reader that writes takes a private copy (``.clone()``) first."""
    want = _tensor(torch.float32, (512, 512))              # 1 MiB
    ref = ray_tpu_torch.put(want)
    first = ray_tpu_torch.get(ref, timeout=60)
    private = first.clone()
    private.add_(1.0)
    _same(ray_tpu_torch.get(ref, timeout=60), want)
    first.add_(1.0)
    second = ray_tpu_torch.get(ref, timeout=60)
    assert second.data_ptr() == first.data_ptr()
    _same(second, want + 1.0)
    _same(ray_tpu_torch.get(echo.remote(ref), timeout=120), want + 1.0)
