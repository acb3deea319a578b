"""Flash attention: the Hopper kernels, their plain versions, and the
public ``flash_attention`` with the reference's dispatch rules and
gradient.

Kernel B1 (``csrc/flash_fwd.cu``) replaces the TPU kernel
``ray_tpu/ops/attention.py::_fwd_kernel`` (launched by ``_flash_fwd_bhsd``).
It computes the same function: causal or full attention with an online
softmax in f32, P rounded to the input type before P.V, causally dead key
tiles skipped, O and the per-row f32 log-sum-exp written (O = 0 and
LSE = -1e30 where a row has no visible key). On the H100 its bound at the
serving shapes (S <= 512, D = 128, bf16) is bytes: about 5 us at S = 512
(16.8 MB at 3.35 TB/s, against 2.2 us of products at the tensor cores'
989 TFLOP/s); at the training shape (B = 4, S = 1024) bytes and products
are close (0.040 and 0.035 ms). In bf16 it runs both products on the
tensor cores (mma.sync, P kept in registers as the A fragment of P.V); in
f32 as scalar FMAs, which keeps it exact. The design notes are in the
source.

Kernels B2 and B3 (``csrc/flash_bwd.cu``) replace the TPU backward kernels
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` (launched by ``_bhsd_bwd``):
dK and dV per key tile over the query tiles that see it, and dQ per query
tile over its key tiles, from O's saved LSE and delta = rowsum(dO * O)
(computed here in f32, as the reference does). They round where the TPU
kernels round (P before P^T dO, dS before dS^T Q and dS K) and take the
same two types: bf16 on the tensor cores (mma.sync, from the helpers
they share with B1 in ``csrc/hopper.cuh``), f32 as scalar FMAs, which
keeps it exact. ``flash_attention`` is a
``torch.autograd.Function`` whose forward launches B1 and whose backward
launches B2 and B3, the counterpart of the reference's ``custom_vjp``.

Rules kept from the reference (``ray_tpu/ops/attention.py``):

- sequences shorter than 128 take plain math (``_use_kernel``), and
  autograd runs through it (the reference's XLA vjp);
- non-causal attention needs both lengths to be multiples of 128;
- ragged causal lengths are fine: the kernels mask by absolute index, so
  nothing is padded along the sequence (a TPU tiling constraint);
- head dims below 128 are padded with zeros up to 128, as ``_prep`` pads
  them to the TPU's lane width, with the scale 1/sqrt(D) of the unpadded D;
  the outputs are sliced back to D. The kernels are built at 128, so a
  wider head raises.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain versions, CUDA tensors the kernels, which launch or raise. There is
no fallback from one to the other. Layout is [B, S, H, D] at the public
function, as in the reference and ``models/llama.py``; LSE is [B, H, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from ray_tpu_torch.observability.xla import kernel_cost

NEG_INF = -1e30
MIN_KERNEL_SEQ = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIM = 128


def default_scale(q: torch.Tensor) -> float:
    """1/sqrt(D) of q's own head dim."""
    return 1.0 / math.sqrt(q.shape[-1])


def pad_head(t: torch.Tensor, width: int = KERNEL_HEAD_DIM) -> torch.Tensor:
    """t [..., D] with zeros appended along D up to ``width`` (t itself
    when D is ``width``): zero columns add nothing to any product, so the
    kernels' outputs sliced back to D are those at D."""
    pad = width - t.shape[-1]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def visible_pairs(S: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs one head attends: all S * Sk, or under the
    causal mask (query i sees keys 0..i) S(S+1)/2 when S == Sk."""
    if not causal:
        return S * Sk
    if S <= Sk:
        return S * (S + 1) // 2
    return Sk * (Sk + 1) // 2 + (S - Sk) * Sk


def fwd_cost(q: torch.Tensor, k: torch.Tensor, causal: bool) -> kernel_cost:
    """B1's count, the one its bound uses: two products of 2 * D flops
    per visible pair; q, k, v read once, O and the f32 LSE written once;
    one exp per visible pair."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    pairs = B * H * visible_pairs(S, Sk, causal)
    elem = q.element_size()
    nbytes = 2 * B * (S + Sk) * H * D * elem + 4 * B * H * S
    return kernel_cost(4.0 * D * pairs, nbytes, pairs)


def bwd_cost(q: torch.Tensor, k: torch.Tensor, causal: bool,
             dkv: bool = True, dq: bool = True) -> kernel_cost:
    """B2's count (``dkv``: 4 products, dK and dV written) plus B3's
    (``dq``: 3 products, dQ written), the ones their bounds use: 2 * D
    flops a product per visible pair; q, k, v, dO read once, LSE and
    delta (f32) read once; one exp per visible pair each."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    pairs = B * H * visible_pairs(S, Sk, causal)
    elem = q.element_size()
    read = 2 * B * (S + Sk) * H * D * elem + 2 * B * H * S * 4
    flops = nbytes = exps = 0
    if dkv:
        flops, nbytes, exps = (4 * 2.0 * D * pairs,
                               read + 2 * B * Sk * H * D * elem, pairs)
    if dq:
        flops += 3 * 2.0 * D * pairs
        nbytes += read + B * S * H * D * elem
        exps += pairs
    return kernel_cost(flops, nbytes, exps)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (O [B, S, H, D] in q's
    type, LSE [B, H, S] f32), scores scaled by ``scale`` (default
    1/sqrt(D)). Scores and P.V accumulate in f32 (operands upcast, so
    bf16 products are exact); P is rounded to v's type before P.V, as in
    the kernel. Keys are masked with -1e30 as in the reference, so a row
    with no visible key gives O = 0 and LSE = -1e30. Counts as B1 in a
    program's costs (``fwd_cost``)."""
    with fwd_cost(q, k, causal):
        return _attention_plain(q, k, v, causal, scale)


def _attention_plain(q, k, v, causal, scale):
    S, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (default_scale(q) if scale is None else scale)
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


def _cuda_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *more: torch.Tensor) -> None:
    """Raise unless the tensors are what every kernel here takes: CUDA
    tensors on one device, contiguous, q/k/v in f32 or bf16 at a head dim
    of at most 128 (narrower heads are padded to 128 by the wrappers)."""
    _check(q, k, v)
    if q.shape[-1] > KERNEL_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {q.shape[-1]}; the flash kernels of the "
            f"training slice are built at {KERNEL_HEAD_DIM} and pad "
            f"narrower heads, and wider heads are not ported")
    for t in (q, k, v, *more):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")


def _launch(source: str, symbol: str, tensors, q: torch.Tensor,
            k: torch.Tensor, causal: bool, scale: float) -> None:
    """Call ``symbol`` of the library built from ``csrc/<source>.cu``:
    (pointers..., B, S, Sk, H, D, dtype, causal, scale, stream), on
    q's device and current stream, q and k at the kernels' head dim.
    Raises on a misaligned tensor and on a refused launch."""
    ptrs = [t.data_ptr() for t in tensors]
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{symbol}: the kernels read 16-byte aligned "
                         f"tensors")
    from ray_tpu_torch.ops import _build

    lib = _build.load(source)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    err_string = getattr(lib, f"{source}_error_string")
    err_string.restype = ctypes.c_char_p
    err_string.argtypes = [ctypes.c_int]
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, B, S, k.shape[1], H, D, _DTYPE_CODES[q.dtype],
                 int(bool(causal)), scale, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{err_string(err).decode()} ({err})")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B1 on q [B, S, H, D], k/v [B, Sk, H, D] (CUDA,
    contiguous, f32 or bf16, D <= 128; below 128 padded with zeros, scale
    1/sqrt(D)). Returns (O [B, S, H, D], LSE [B, H, S] f32). Raises on
    any input the kernel does not take and on a refused launch.
    ``flash_fwd_cuda.launches`` counts launches; a program's costs count
    ``fwd_cost``."""
    _cuda_inputs("flash_fwd_cuda", q, k, v)
    B, S, H, D = q.shape
    scale = default_scale(q)
    with fwd_cost(q, k, causal):
        q, k, v = pad_head(q), pad_head(k), pad_head(v)
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        _launch("flash_fwd", "flash_fwd", (q, k, v, out, lse), q, k, causal,
                scale)
        flash_fwd_cuda.launches += 1
        return out[..., :D].contiguous(), lse


flash_fwd_cuda.launches = 0


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B, H, S]: the backward's per-row
    term, computed outside the kernels as the reference does."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The function of kernels B2 and B3 in plain PyTorch: (dQ, dK, dV)
    in q's type from O, its LSE [B, H, S] and dO, scores scaled by
    ``scale`` (default 1/sqrt(D)). Products take operands of the input
    type (upcast, so bf16 products are exact) and sum in f32; P is
    rounded to the input type before P^T dO and dS before dS^T Q and
    dS K, as in the kernels. Masked pairs get P = 0 by index. Counts as
    B2 plus B3 in a program's costs (``bwd_cost``)."""
    with bwd_cost(q, k, causal):
        return _attention_bwd_plain(q, k, v, out, lse, do, causal, scale)


def _attention_bwd_plain(q, k, v, out, lse, do, causal, scale):
    S, Sk = q.shape[1], k.shape[1]
    if scale is None:
        scale = default_scale(q)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = attention_delta(out, do)[..., None]                # [B,H,S,1]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _bwd_inputs(name, q, k, v, do, lse, delta):
    _cuda_inputs(name, q, k, v, do, lse, delta)
    B, S, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must match q, got {tuple(do.shape)} "
                         f"{do.dtype}")
    for t in (lse, delta):
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name}: LSE and delta must be [B, H, S] "
                             f"f32, got {tuple(t.shape)} {t.dtype}")


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B2: (dK, dV) [B, Sk, H, D] in q's type from q, dO
    [B, S, H, D], k, v [B, Sk, H, D] and LSE, delta [B, H, S] f32 (CUDA,
    contiguous, f32 or bf16, D <= 128; below 128 padded with zeros,
    scale 1/sqrt(D)). Raises on any input the kernel does not take and on
    a refused launch. ``.launches`` counts launches."""
    _bwd_inputs("flash_bwd_dkv_cuda", q, k, v, do, lse, delta)
    D, scale = q.shape[-1], default_scale(q)
    with bwd_cost(q, k, causal, dq=False):
        q, k, v, do = (pad_head(t) for t in (q, k, v, do))
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _launch("flash_bwd", "flash_bwd_dkv",
                (q, k, v, do, lse, delta, dk, dv), q, k, causal, scale)
        flash_bwd_dkv_cuda.launches += 1
        return dk[..., :D].contiguous(), dv[..., :D].contiguous()


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool = True
                      ) -> torch.Tensor:
    """Launch kernel B3: dQ [B, S, H, D] in q's type, from the same inputs
    as ``flash_bwd_dkv_cuda``. ``.launches`` counts launches."""
    _bwd_inputs("flash_bwd_dq_cuda", q, k, v, do, lse, delta)
    D, scale = q.shape[-1], default_scale(q)
    with bwd_cost(q, k, causal, dkv=False):
        q, k, v, do = (pad_head(t) for t in (q, k, v, do))
        dq = torch.empty_like(q)
        _launch("flash_bwd", "flash_bwd_dq", (q, k, v, do, lse, delta, dq),
                q, k, causal, scale)
        flash_bwd_dq_cuda.launches += 1
        return dq[..., :D].contiguous()


flash_bwd_dq_cuda.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dQ, dK, dV) of flash attention: the plain version for CPU tensors,
    kernels B2 and B3 for CUDA tensors. dO is cast to q's type and made
    contiguous (the gradient that reaches attention may be a strided
    view). The cast, the copy and delta count inside B2's and B3's cost,
    on both devices alike."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    with bwd_cost(q, k, causal):
        do = do.to(q.dtype)
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        do = do.contiguous()
        delta = attention_delta(out, do)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
        return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """O and LSE from B1 (or its plain version) in the forward; dQ, dK, dV
    from B2 and B3 (or their plain version) in the backward. Saves q, k,
    v, O and the f32 LSE; LSE is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention: no kernel for {q.device}")
        # The copies into contiguous inputs count inside B1's cost.
        with fwd_cost(q, k, causal):
            if q.device.type == "cpu":
                out, lse = flash_attention_plain(q, k, v, causal)
            else:
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                out, lse = flash_fwd_cuda(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """q, k, v [B, S, H, D] -> O [B, S, H, D] (and LSE [B, H, S] f32 with
    ``return_lse``), differentiable in q, k and v. Below 128 tokens the
    reference's plain attention (``models.llama.xla_attention``) gives O
    and autograd runs through it, as in the reference."""
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
    out, lse = _FlashAttention.apply(q, k, v, causal)
    return (out, lse) if return_lse else out
