"""Fused blockwise lm_head + cross-entropy: the [N, V] logits never exist
whole. The counterpart of ``ray_tpu/ops/fused_loss.py``.

The forward streams over vocab blocks with an online logsumexp; the
backward recomputes each block's logits and accumulates dh and the
block's slice of d(head). Peak memory is O(N * block), which is what
makes a 128k vocabulary affordable at training batch sizes.

Rounding is the reference's: the logits are f32 from operands of the
compute type (upcast here, so bf16 products are exact, and summed in
f32, the counterpart of ``preferred_element_type=f32``); the softmax and
its reductions are f32; the gradient of the logits is rounded to h's type
before the two products of the backward, which give h's type, and dh is
summed across blocks in h's type. The last block is cut to the vocabulary
instead of padded and masked, which gives the same values. This is not a
Pallas kernel in the reference, so its products are ``torch.matmul``.
"""

from __future__ import annotations

import torch

DEFAULT_BLOCK = 8192


def _block_logits(h32: torch.Tensor, head: torch.Tensor, base: int,
                  block: int) -> torch.Tensor:
    return h32 @ head[:, base:base + block].float()


class _BlockwiseXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, head, targets, block):
        n = h.shape[0]
        vocab = head.shape[1]
        h32 = h.float()
        m = torch.full((n,), -1e30, dtype=torch.float32, device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        tgt = torch.zeros((n,), dtype=torch.float32, device=h.device)
        for base in range(0, vocab, block):
            logits = _block_logits(h32, head, base, block)    # [N, <=block]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            width = logits.shape[1]
            in_blk = (targets >= base) & (targets < base + width)
            local = (targets - base).clamp(0, width - 1)
            tgt = torch.where(
                in_blk, logits.gather(1, local[:, None])[:, 0], tgt)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, head, targets, lse)
        ctx.block = block
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        h, head, targets, lse = ctx.saved_tensors
        block = ctx.block
        h32 = h.float()
        dh = torch.zeros_like(h)
        dhead = torch.empty_like(head)
        for base in range(0, head.shape[1], block):
            logits = _block_logits(h32, head, base, block)
            col = base + torch.arange(logits.shape[1], device=h.device)
            p = torch.exp(logits - lse[:, None])
            onehot = (col[None, :] == targets[:, None]).float()
            glc = ((p - onehot) * g[:, None]).to(h.dtype)      # [N, block]
            blk = head[:, base:base + block].to(h.dtype)
            dh = dh + glc @ blk.t()
            dhead[:, base:base + block] = (h.t() @ glc).to(head.dtype)
        return dh, dhead, None, None


def blockwise_xent(h: torch.Tensor, head: torch.Tensor,
                   targets: torch.Tensor,
                   block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-token NLL, logsumexp(h @ head) - (h @ head)[target], as f32
    [N], from h [N, D], head [D, V] (both in the compute type) and
    integer targets [N]; differentiable in h and head."""
    if h.dim() != 2 or head.dim() != 2 or h.shape[1] != head.shape[0]:
        raise ValueError(f"expected h [N, D] and head [D, V], got "
                         f"{tuple(h.shape)} and {tuple(head.shape)}")
    if targets.shape != (h.shape[0],):
        raise ValueError(f"targets must be [N], got {tuple(targets.shape)}")
    return _BlockwiseXent.apply(h, head, targets.long(), block)
