"""Flash attention forward: the Hopper kernel, its plain version, and the
public ``flash_attention`` with the reference's dispatch rules.

Kernel B1 (``csrc/flash_fwd.cu``) replaces the TPU kernel
``ray_tpu/ops/attention.py::_fwd_kernel`` (launched by ``_flash_fwd_bhsd``).
It computes the same function: causal or full attention with an online
softmax in f32, P rounded to the input type before P.V, causally dead key
tiles skipped, O and the per-row f32 log-sum-exp written (O = 0 and
LSE = -1e30 where a row has no visible key). On the H100 its bound at the
serving shapes (S <= 512, D = 128, bf16) is bytes, not operations: about
5 us at S = 512 (16.8 MB at 3.35 TB/s, against 2.2 us of products at the
tensor cores' 989 TFLOP/s). This first version runs the products as
register-tiled scalar f32 FMAs on the CUDA cores, which is simple and exact
for f32 inputs, and so sits 60-70 times above that bound; tensor cores are
a later version's. It takes f32 and bf16 at head dim 128, the serving
path's types and width, and refuses anything else. The design notes are in
the source.

Rules kept from the reference (``ray_tpu/ops/attention.py``):

- sequences shorter than 128 take plain math (``_use_kernel``);
- non-causal attention needs both lengths to be multiples of 128;
- ragged causal lengths are fine: the kernel masks by absolute index, so
  nothing is padded (padding was a TPU tiling constraint).

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors the kernel, which launches or raises. There is
no fallback from one to the other. Layout is [B, S, H, D] at the public
function, as in the reference and ``models/llama.py``; LSE is [B, H, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

NEG_INF = -1e30
MIN_KERNEL_SEQ = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (O [B, S, H, D] in q's
    type, LSE [B, H, S] f32). Scores and P.V accumulate in f32 (operands
    upcast, so bf16 products are exact); P is rounded to v's type before
    P.V, as in the kernel. Keys are masked with -1e30 as in the reference,
    so a row with no visible key gives O = 0 and LSE = -1e30."""
    D = q.shape[-1]
    S, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    dead = l == 0.0
    l_safe = torch.where(dead, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (pv / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = torch.where(dead, torch.full_like(l, NEG_INF), m + torch.log(l_safe))
    return out, lse[..., 0]


def _check(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q, k, v as [B, S, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != \
            (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError("q and k/v must agree on batch, heads, head dim")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B1 on q [B, S, H, D], k/v [B, Sk, H, D] (CUDA,
    contiguous, f32 or bf16, head dim 128). Returns
    (O, LSE [B, H, S] f32). Raises on any input the kernel does not take
    and on a refused launch. ``flash_fwd_cuda.launches`` counts launches."""
    from ray_tpu_torch.ops import _build

    _check(q, k, v)
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash_fwd_cuda needs CUDA tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("flash_fwd_cuda needs contiguous tensors")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v on different devices")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd_cuda: unsupported dtype {q.dtype}")
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_fwd_cuda: head dim {D}, the kernel is "
                         f"built for {KERNEL_HEAD_DIM}")
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, S, Sk, H, D, _DTYPE_CODES[q.dtype],
                 int(bool(causal)), 1.0 / math.sqrt(D), stream)
    if err != 0:
        msg = lib.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} ({err})")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """q, k, v [B, S, H, D] -> O [B, S, H, D] (and LSE [B, H, S] f32 with
    ``return_lse``). Below 128 tokens the reference's plain attention
    (``models.llama.xla_attention``) gives O, as in the reference."""
    _check(q, k, v)
    S, Sk = q.shape[1], k.shape[1]
    if S < MIN_KERNEL_SEQ or Sk < MIN_KERNEL_SEQ:
        from ray_tpu_torch.models.llama import xla_attention

        out = xla_attention(q, k, v, causal=causal)
        if not return_lse:
            return out
        return out, flash_attention_plain(q, k, v, causal)[1]
    if not causal and (S % 128 or Sk % 128):
        raise NotImplementedError(
            "non-causal flash requires seq_len % 128 == 0")
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal)
    elif q.device.type == "cuda":
        out, lse = flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal)
    else:
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return (out, lse) if return_lse else out
