"""Llama-2/3 decoder for serving and training, in PyTorch: the counterpart
of ``ray_tpu/models/llama.py`` (its serving and training halves).

Params are the JAX package's tree, as tensors: ``embed`` [V, D],
``layers`` (a dict of weights stacked on a leading [n_layers] axis, stored
[in, out] and applied as ``x @ W``), ``norm_f``, and ``lm_head`` unless
the embeddings are tied. ``quantize_weights_int8`` turns each large weight
``w`` into ``w_q`` (int8) + ``w_s`` (f32 scales), read back by ``_weight``.
``Llama`` wraps such a tree as an ``nn.Module``; the inference functions
below take the tree directly, as the engine does. Eager PyTorch runs the
layer loop in Python where the reference scans a compiled layer body.

Numerics against the JAX package (the tests hold each of these):

- f32 compute matches to f32 rounding: logits and caches within 1e-4
  (``tests/test_torch_llama.py``), greedy tokens identical.
- bf16 compute rounds at the same places as the reference (the matmul
  outputs, ``rms_norm`` after normalising in f32, rope after rotating in
  f32, the attention scores before their f32 softmax, the probabilities
  before P.V), but the two frameworks sum matmuls in different orders and
  in different internal precision, so values agree only to bf16 rounding:
  logits within 5e-2 absolute at ``tiny`` size, which is the reference's
  own bf16 bound for flash attention (``tests/test_ops.py``).
- logits are f32 from bf16 operands: the reference asks XLA for an f32
  result of a bf16 product (``preferred_element_type``); here both
  operands are upcast to f32 first, which gives the same exact products
  (a bf16 x bf16 product fits in f32) summed in f32.
- int8 quantization is bit-identical: both round half to even, and the
  scale (max |w| over the input axis / 127, floored at 1e-8) is the same
  f32 arithmetic. Dequantization multiplies in the compute dtype, as the
  reference does.

- training: ``loss_fn`` (fused blockwise or materialized logits, with an
  optional mask) and its gradients match the reference to f32 rounding in
  f32 (``tests/test_torch_train.py``). The embedding's gradient sums
  repeated tokens in f32 and then rounds, as the reference's one-hot
  matmul does. ``remat`` is per-layer ``torch.utils.checkpoint``:
  ``True`` recomputes the whole layer, ``"dots"`` keeps the weight
  matmuls' outputs (``aten.mm``, products without batch dimensions, the
  counterpart of ``dots_with_no_batch_dims_saveable``); neither changes a
  value.

- paged KV (``init_paged_kv_cache``, ``decode_step_paged``,
  ``verify_kv_paged``, ``prefill_kv_paged``): the reference's functions
  on the same pools and tables, to the same tolerances
  (``tests/test_torch_paged.py``). The pool carries one sink block past
  the reference's (``init_paged_kv_cache``) where inactive rows write.

``n_experts > 0`` (MoE) and ``attn_impl="ring"`` belong to later slices
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device

Params = Dict[str, Any]
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16      # activation/matmul dtype
    param_dtype: torch.dtype = torch.float32
    attn_impl: Any = "xla"                   # "xla" | "flash" | callable
    remat: Any = False
    tie_embeddings: bool = False
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, hidden_dim=11008, max_seq_len=4096), **overrides})

    @staticmethod
    def llama3_8b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, hidden_dim=14336, max_seq_len=8192,
            rope_theta=500000.0), **overrides})

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-size config: runs on the CPU in milliseconds."""
        return LlamaConfig(**{**dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=128), **overrides})

    def num_params(self) -> int:
        d, h, v = self.dim, self.hidden_dim, self.vocab_size
        per_layer = (self.dim * self.head_dim * self.n_heads
                     + 2 * self.dim * self.head_dim * self.n_kv_heads
                     + self.dim * self.dim + 3 * d * h + 2 * d)
        out_head = 0 if self.tie_embeddings else d * v
        return v * d + self.n_layers * per_layer + d + out_head


def _dense_only(config: LlamaConfig) -> None:
    if config.n_experts:
        raise NotImplementedError(
            "MoE (n_experts > 0) is not ported yet; it comes with the "
            "expert-parallel slice")


# ---------------------------------------------------------------------------
# Init and quantization
# ---------------------------------------------------------------------------

def init_params(config: LlamaConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random stacked-layer params, N(0, 0.02) in ``param_dtype`` (norms
    at 1), drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``. The bits differ from the JAX
    package's ``init_params``; tests share weights through
    ``models.convert.params_from_numpy`` instead."""
    _dense_only(config)
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def dense(*shape):
        return torch.empty(shape, dtype=c.param_dtype, device=dev).normal_(
            0.0, 0.02, generator=gen)

    kd, L = c.head_dim, c.n_layers
    ones = dict(dtype=c.param_dtype, device=dev)
    params: Params = {
        "embed": dense(c.vocab_size, c.dim),
        "layers": {
            "attn_norm": torch.ones((L, c.dim), **ones),
            "wq": dense(L, c.dim, c.n_heads * kd),
            "wk": dense(L, c.dim, c.n_kv_heads * kd),
            "wv": dense(L, c.dim, c.n_kv_heads * kd),
            "wo": dense(L, c.n_heads * kd, c.dim),
            "ffn_norm": torch.ones((L, c.dim), **ones),
            "w_gate": dense(L, c.dim, c.hidden_dim),
            "w_up": dense(L, c.dim, c.hidden_dim),
            "w_down": dense(L, c.hidden_dim, c.dim),
        },
        "norm_f": torch.ones((c.dim,), **ones),
    }
    if not c.tie_embeddings:
        params["lm_head"] = dense(c.dim, c.vocab_size)
    return params


_QUANTIZED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quant(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of one [in, out] matrix."""
    w32 = w.float()
    scale = (w32.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _quant_stacked(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, in, out] one layer slice at a time, so only one slice is ever
    upcast to f32 (at Llama-3-8B a whole stacked ``w_gate`` would be
    7.5 GB in f32)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = _quant(w[i])
    return q, s


def quantize_weights_int8(params: Params) -> Params:
    """Weight-only int8 for serving, as in the reference: every large
    matmul weight becomes ``name_q`` (int8) + ``name_s`` (f32 scales, max
    |w| over the input axis / 127, floored at 1e-8, round half to even);
    norms and the embedding stay as they are. Each quantized input tensor
    is dropped from the result as soon as it is converted, so the caller
    that lets go of ``params`` frees it one weight at a time."""
    layers = dict(params["layers"])
    out: Params = {"embed": params["embed"], "norm_f": params["norm_f"]}
    qlayers: Dict[str, torch.Tensor] = {
        "attn_norm": layers.pop("attn_norm"),
        "ffn_norm": layers.pop("ffn_norm")}
    for name in _QUANTIZED:
        qlayers[name + "_q"], qlayers[name + "_s"] = _quant_stacked(
            layers.pop(name))
    out["layers"] = qlayers
    if "lm_head" in params:
        out["lm_head_q"], out["lm_head_s"] = _quant(params["lm_head"])
    return out


def _weight(p: Dict[str, torch.Tensor], name: str,
            dtype: torch.dtype) -> torch.Tensor:
    """A matmul weight in the compute dtype, dequantizing an int8 + scale
    pair as ``q.to(dtype) * s.to(dtype)`` (the product rounds in
    ``dtype``, as in the reference)."""
    q = p.get(name + "_q")
    if q is not None:
        return q.to(dtype) * p[name + "_s"].to(dtype)
    return p[name].to(dtype)


def _layer_views(params: Params) -> List[Dict[str, torch.Tensor]]:
    """Every layer's params as views of the stacked tensors, taken with
    one ``unbind`` per tensor: its backward stacks the layers' gradients
    once, where indexing each layer would add a full-size zero tensor
    per layer."""
    views = {k: v.unbind(0) for k, v in params["layers"].items()}
    n = len(next(iter(views.values())))
    return [{k: v[i] for k, v in views.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """Normalise in f32, round to x's dtype, then scale by the weight in
    that dtype (the reference's order of rounding)."""
    x32 = x.float()
    rrms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rrms).to(x.dtype) * weight.to(x.dtype)


def rope_freqs(head_dim: int, max_len: int, theta: float,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                       # [S, D/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [S, D/2]. Half-split rotation in f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's plain attention, [B, S, H, D]: scores in the input
    dtype, softmax in f32, probabilities rounded back before P.V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        q_pos = (torch.arange(s_q, device=q.device) if positions is None
                 else positions)[:, None]
        mask = q_pos >= torch.arange(s_k, device=q.device)[None, :]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def _get_attention_fn(impl) -> Callable:
    if callable(impl):
        return impl
    if impl == "flash":
        from ray_tpu_torch.ops.attention import flash_attention

        return flash_attention
    if impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (context parallel) is not ported yet; it "
            "comes with the sequence-parallel slice")
    if impl == "xla":
        return xla_attention
    raise ValueError(f"unknown attn_impl {impl!r}")


class _EmbedLookup(torch.autograd.Function):
    """Gather, then cast: the same values as the reference's cast-then-
    gather, without casting the whole [V, D] table on every call. The
    backward sums the rows of repeated tokens in f32 and rounds once to
    the compute type, then to the table's type, as the reference's
    one-hot matmul (``preferred_element_type=f32``) and its cast do;
    autograd's own index backward would sum in the table's type."""

    @staticmethod
    def forward(ctx, embed, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.table_dtype, ctx.dtype = (
            embed.shape, embed.dtype, dtype)
        return embed[tokens].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_add_(0, tokens.reshape(-1),
                       g.reshape(-1, ctx.shape[1]).float())
        return acc.to(ctx.dtype).to(ctx.table_dtype), None, None


def _embed(params: Params, tokens: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return _EmbedLookup.apply(params["embed"], tokens, dtype)


def lm_head_weight(params: Params, config: LlamaConfig) -> torch.Tensor:
    """Output projection [D, V] in the compute dtype (tied or not)."""
    if config.tie_embeddings:
        return params["embed"].t().to(config.dtype)
    return _weight(params, "lm_head", config.dtype)


def _logits(x: torch.Tensor, params: Params,
            config: LlamaConfig) -> torch.Tensor:
    """f32 logits of compute-dtype operands (both upcast: exact products,
    f32 sums), the counterpart of ``preferred_element_type=f32``."""
    return x.float() @ lm_head_weight(params, config).float()


def _ffn(x: torch.Tensor, p: Dict[str, torch.Tensor],
         c: LlamaConfig) -> torch.Tensor:
    h = rms_norm(x, p["ffn_norm"], c.norm_eps)
    gate = F.silu(h @ _weight(p, "w_gate", c.dtype))
    up = h @ _weight(p, "w_up", c.dtype)
    return x + (gate * up) @ _weight(p, "w_down", c.dtype)


def _qkv(x: torch.Tensor, p: Dict[str, torch.Tensor], c: LlamaConfig):
    B, S, _ = x.shape
    kd = c.head_dim
    h = rms_norm(x, p["attn_norm"], c.norm_eps)
    q = (h @ _weight(p, "wq", c.dtype)).reshape(B, S, c.n_heads, kd)
    k = (h @ _weight(p, "wk", c.dtype)).reshape(B, S, c.n_kv_heads, kd)
    v = (h @ _weight(p, "wv", c.dtype)).reshape(B, S, c.n_kv_heads, kd)
    return q, k, v


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(c: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor,
           attn_fn: Callable, x: torch.Tensor, p: Dict[str, torch.Tensor]):
    """One decoder layer: x [B, S, D] -> (x, pre-repeat k, v)."""
    B, S, _ = x.shape
    rep = c.n_heads // c.n_kv_heads
    q, k, v = _qkv(x, p, c)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, _repeat_kv(k, rep), _repeat_kv(v, rep), causal=True)
    x = x + attn.reshape(B, S, -1) @ _weight(p, "wo", c.dtype)
    return _ffn(x, p, c), k, v


def prefill_kv(params: Params, tokens: torch.Tensor, config: LlamaConfig,
               attn_impl: Optional[Any] = None):
    """Prefill trunk: prompt [B, P] -> (normed hidden [B, P, D], per-layer
    pre-repeat ks/vs [L, B, P, n_kv, head_dim]). Shared by ``prefill``
    and the engine's insert, so both give the same KV."""
    _dense_only(config)
    c = config
    cos, sin = rope_freqs(c.head_dim, tokens.shape[1], c.rope_theta,
                          tokens.device)
    attn_fn = _get_attention_fn(attn_impl or c.attn_impl)
    x = _embed(params, tokens, c.dtype)
    ks, vs = [], []
    for p in _layer_views(params):
        x, k, v = _layer(c, cos, sin, attn_fn, x, p)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["norm_f"], c.norm_eps)
    return x, torch.stack(ks), torch.stack(vs)


def _save_matmuls(ctx, op, *args, **kwargs):
    """remat="dots": keep the weight matmuls' outputs (``aten.mm``, no
    batch dimensions), recompute everything else, attention included."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_dots():
    return create_selective_checkpoint_contexts(_save_matmuls)


def forward_hidden(params: Params, tokens: torch.Tensor, config: LlamaConfig,
                   attn_impl: Optional[Any] = None):
    """Trunk only: tokens [B, S] -> (normed hidden [B, S, D], aux). aux is
    the MoE load-balance term of the reference, 0 for a dense model.
    ``config.remat`` checkpoints each layer: ``True`` whole, ``"dots"``
    keeping its weight matmuls' outputs."""
    _dense_only(config)
    c = config
    if isinstance(c.remat, str) and c.remat != "dots":
        raise ValueError(
            f"remat={c.remat!r}: expected False, True, or 'dots'")
    cos, sin = rope_freqs(c.head_dim, tokens.shape[1], c.rope_theta,
                          tokens.device)
    attn_fn = _get_attention_fn(attn_impl or c.attn_impl)

    def layer(x, p):
        return _layer(c, cos, sin, attn_fn, x, p)[0]

    x = _embed(params, tokens, c.dtype)
    for p in _layer_views(params):
        if c.remat == "dots":
            x = checkpoint(layer, x, p, use_reentrant=False,
                           context_fn=_remat_dots)
        elif c.remat:
            x = checkpoint(layer, x, p, use_reentrant=False)
        else:
            x = layer(x, p)
    x = rms_norm(x, params["norm_f"], c.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            attn_impl: Optional[Any] = None) -> torch.Tensor:
    """tokens [B, S] -> f32 logits [B, S, V]."""
    x, _ = forward_hidden(params, tokens, config, attn_impl)
    return _logits(x, params, config)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig, attn_impl: Optional[Any] = None,
            fused: bool = True) -> torch.Tensor:
    """Next-token cross-entropy, f32 scalar. batch: ``tokens`` [B, S]
    (+ optional ``mask`` [B, S], weighting each target by mask[:, 1:]).

    ``fused`` streams the lm_head product and logsumexp over vocab blocks
    (``ops.fused_loss``) so the [B, S, V] logits never exist whole; the
    reference's default, which it also reads from ``RAY_TPU_FUSED_LOSS``
    (the port takes the argument only). Both routes give the same values
    to f32 rounding."""
    c = config
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    hidden, aux = forward_hidden(params, tokens[:, :-1], c, attn_impl)
    if fused:
        from ray_tpu_torch.ops.fused_loss import blockwise_xent

        b, s, d = hidden.shape
        nll = blockwise_xent(hidden.reshape(b * s, d),
                             lm_head_weight(params, c),
                             targets.reshape(-1)).reshape(b, s)
    else:
        logits = _logits(hidden, params, c)
        tgt = logits.gather(-1, targets[..., None].long())[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - tgt
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].float()
        return (nll * m).sum() / m.sum().clamp_min(1.0) + aux
    return nll.mean() + aux


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs/token (fwd+bwd ~ 6*N + attention), the
    reference's formula."""
    n = config.num_params()
    attn = 12 * config.n_layers * config.dim * seq_len
    return 6.0 * n + attn


# ---------------------------------------------------------------------------
# Inference: KV-cache decode and generation
# ---------------------------------------------------------------------------

def init_kv_cache(config: LlamaConfig, batch_size: int,
                  max_len: Optional[int] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Stacked per-layer cache [L, B, S, n_kv, head_dim] in the compute
    dtype, zeroed, on ``device`` (default: the card)."""
    c = config
    S = max_len or c.max_seq_len
    shape = (c.n_layers, batch_size, S, c.n_kv_heads, c.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev)}


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, D]; caches [B, S, kvH, D]; attends to positions <= pos.
    Query heads are grouped over their kv head (head h reads kv head
    h // rep, as the reference's repeat does) instead of repeating the
    cache: the same products, without copying the cache rep times."""
    B, S, KVH, D = k_cache.shape
    H = q.shape[2]
    rep = H // KVH
    qg = q.reshape(B, KVH, rep, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache).float() * scale
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            <= pos[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache)
    return out.reshape(B, 1, H, D)


def _rope_rows(t: torch.Tensor, pc: torch.Tensor,
               ps: torch.Tensor) -> torch.Tensor:
    """t [B, K, H, D] rotated at per-row positions (pc/ps [B, K, 1, D/2]),
    half-split, in f32."""
    t1, t2 = t.float().chunk(2, dim=-1)
    return torch.cat([t1 * pc - t2 * ps, t2 * pc + t1 * ps],
                     dim=-1).to(t.dtype)


def _decode_trunk(params: Params, tokens: torch.Tensor, qpos: torch.Tensor,
                  config: LlamaConfig, rope_len: int,
                  attend: Callable) -> torch.Tensor:
    """The incremental trunk shared by ``decode_step``,
    ``decode_step_paged`` and ``verify_kv_paged``: tokens [B, K] at
    absolute positions ``qpos`` [B, K] (each < ``rope_len``) -> normed
    hidden [B, K, D]. ``attend(i, q, k, v)`` writes layer i's new k/v
    into its cache and returns the attention output [B, K, H, D]."""
    c = config
    B, K = tokens.shape
    cos, sin = rope_freqs(c.head_dim, rope_len, c.rope_theta,
                          tokens.device)
    pc = cos[qpos][:, :, None, :]                     # [B, K, 1, D/2]
    ps = sin[qpos][:, :, None, :]
    x = _embed(params, tokens, c.dtype)
    for i, p in enumerate(_layer_views(params)):
        q, k, v = _qkv(x, p, c)
        q, k = _rope_rows(q, pc, ps), _rope_rows(k, pc, ps)
        attn = attend(i, q, k, v)
        x = x + attn.reshape(B, K, -1) @ _weight(p, "wo", c.dtype)
        x = _ffn(x, p, c)
    return rms_norm(x, params["norm_f"], c.norm_eps)


def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor,
                config: LlamaConfig,
                active: Optional[torch.Tensor] = None):
    """One incremental token: tokens [B] at ``positions`` [B] (each in
    [0, S)). Returns (f32 logits [B, V], cache).

    The cache is updated IN PLACE (the reference donates it to the
    compiled step instead) and returned for symmetry. ``active`` [B] bool
    masks the KV write: an inactive row writes back the value already at
    its position, so its cache rows stay bit-for-bit untouched (the
    reference pushes the write index out of bounds, where XLA's scatter
    drops it; PyTorch indexing would raise). That is safe here because
    every row owns its own cache stripe; the paged layout, where rows
    share one pool, uses a sink block instead. Logits of inactive rows
    are garbage by construction and ignored by callers."""
    _dense_only(config)
    S = cache["k"].shape[2]
    B = tokens.shape[0]
    bidx = torch.arange(B, device=tokens.device)
    keep = None if active is None else active.to(tokens.device)[:, None,
                                                               None]

    def attend(i, q, k, v):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_new, v_new = k[:, 0], v[:, 0]
        if keep is not None:
            k_new = torch.where(keep, k_new, k_cache[bidx, positions])
            v_new = torch.where(keep, v_new, v_cache[bidx, positions])
        k_cache[bidx, positions] = k_new
        v_cache[bidx, positions] = v_new
        return _decode_attention(q, k_cache, v_cache, positions)

    x = _decode_trunk(params, tokens[:, None], positions[:, None], config,
                      S, attend)
    return _logits(x[:, 0], params, config), cache


# ---------------------------------------------------------------------------
# Inference: the paged KV layout
# ---------------------------------------------------------------------------

def init_paged_kv_cache(config: LlamaConfig, num_blocks: int,
                        block_size: int,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Paged cache: one pool of KV blocks shared by all sequences,
    ``[L, num_blocks + 1, block_size, n_kv, head_dim]`` in the compute
    dtype, zeroed, on ``device`` (default: the card). A sequence owns a
    *block table*, the physical block ids covering its logical positions
    (PagedAttention, arXiv:2309.06180).

    The pool has one block more than the reference's: the last,
    ``num_blocks`` (``sink_block``), is never allocated. Rows a step must
    not write (inactive slots) write there instead: the reference pushes
    their block id out of bounds, where XLA's scatter drops the write,
    and PyTorch would raise. Writing such a row's old value back, as the
    dense ``decode_step`` does, is not safe here: an inactive slot's
    stale table can name a block a live slot writes in the same call,
    and duplicate indices leave either value on the card."""
    c = config
    shape = (c.n_layers, num_blocks + 1, block_size, c.n_kv_heads,
             c.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev)}


def sink_block(pools: Dict[str, torch.Tensor]) -> int:
    """The pool's write-only sink block id (its last)."""
    return pools["k"].shape[1] - 1


def _paged_targets(pools: Dict[str, torch.Tensor], tables: torch.Tensor,
                   qpos: torch.Tensor, active: Optional[torch.Tensor]):
    """(block id, row in block) [B, K] where each query's k/v lands:
    ``(table[pos // bs], pos % bs)``, and the sink block for inactive
    rows. Built on the device: no host sync."""
    bs = pools["k"].shape[2]
    phys = torch.gather(tables, 1, qpos // bs)
    if active is not None:
        phys = torch.where(active.to(phys.device)[:, None], phys,
                           torch.full_like(phys, sink_block(pools)))
    return phys, qpos % bs


def _paged_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each sequence's dense [B, S_pad, n_kv, hd] view of one layer's
    pool [NB + 1, bs, n_kv, hd] through its block table [B, max_blocks]."""
    B, mb = tables.shape
    return pool[tables].reshape(B, mb * pool.shape[1], *pool.shape[2:])


def decode_step_paged(params: Params, pools: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, tokens: torch.Tensor,
                      positions: torch.Tensor, config: LlamaConfig,
                      active: Optional[torch.Tensor] = None):
    """One incremental token against the paged pool: tokens [B] at
    ``positions`` [B], ``block_tables`` [B, max_blocks] mapping each
    sequence's logical block to a pool block. Returns (f32 logits [B, V],
    pools), the pools updated IN PLACE.

    Per layer: the write lands at ``(table[pos // bs], pos % bs)`` (the
    sink block for inactive rows), then each sequence's dense
    ``[S_pad]`` view is gathered (S_pad = max_blocks * bs; after the
    write, so the token attends to itself), then the same
    ``_decode_attention`` as ``decode_step``. On the same contents as a
    dense cache of length S_pad it is that step's arithmetic on an equal
    contiguous tensor, so the same bits."""
    if config.n_experts:
        raise NotImplementedError(
            "paged KV-cache decode for MoE configs is not implemented")
    tables = block_tables.to(tokens.device).long()
    S_pad = tables.shape[1] * pools["k"].shape[2]
    phys, off = _paged_targets(pools, tables, positions[:, None], active)

    def attend(i, q, k, v):
        k_pool, v_pool = pools["k"][i], pools["v"][i]
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
        return _decode_attention(q, _paged_view(k_pool, tables),
                                 _paged_view(v_pool, tables), positions)

    x = _decode_trunk(params, tokens[:, None], positions[:, None], config,
                      S_pad, attend)
    return _logits(x[:, 0], params, config), pools


def _verify_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qpos: torch.Tensor) -> torch.Tensor:
    """q [B, K, H, D] at positions qpos [B, K]; k, v [B, S, kvH, D].
    Query j attends to keys at positions <= qpos[:, j]: scores in the
    input dtype, softmax in f32, probabilities rounded back before P.V,
    query heads grouped over their kv head (the reference repeats the
    kv heads; the products are the same)."""
    B, S, KVH, D = k.shape
    K, H = q.shape[1], q.shape[2]
    qg = q.reshape(B, K, KVH, H // KVH, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqgrd,bsgd->bgrqs", qg, k).float() * scale
    mask = (qpos[:, None, None, :, None]
            >= torch.arange(S, device=q.device)[None, None, None, None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqs,bsgd->bqgrd", probs, v)
    return out.reshape(B, K, H, D)


def verify_kv_paged(params: Params, pools: Dict[str, torch.Tensor],
                    block_tables: torch.Tensor, tokens: torch.Tensor,
                    positions: torch.Tensor, config: LlamaConfig,
                    active: Optional[torch.Tensor] = None):
    """K-token verify step for speculative decoding: tokens [B, K], token
    j of row b at absolute position ``positions[b] + j`` (clamped at
    S_pad - 1, as in the reference). Returns (f32 logits [B, K, V],
    pools), the pools updated IN PLACE.

    Row j's logits are the target's distribution for the token after
    input j, what ``decode_step_paged`` gives after consuming inputs
    0..j one at a time: every op is row-independent, so K queries in one
    call change batching, not the function. All K writes land before the
    gather, so input j sees inputs i < j through the position mask and
    never i > j. Rejected inputs leave stale rows past the accepted
    position, overwritten before they are ever attended. Inactive rows
    write to the sink block."""
    if config.n_experts:
        raise NotImplementedError(
            "paged KV-cache verify for MoE configs is not implemented")
    tables = block_tables.to(tokens.device).long()
    S_pad = tables.shape[1] * pools["k"].shape[2]
    K = tokens.shape[1]
    qpos = torch.clamp(positions[:, None] + torch.arange(
        K, device=tokens.device)[None, :], max=S_pad - 1)      # [B, K]
    phys, off = _paged_targets(pools, tables, qpos, active)

    def attend(i, q, k, v):
        k_pool, v_pool = pools["k"][i], pools["v"][i]
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
        return _verify_attention(q, _paged_view(k_pool, tables),
                                 _paged_view(v_pool, tables), qpos)

    x = _decode_trunk(params, tokens, qpos, config, S_pad, attend)
    return _logits(x, params, config), pools


def prefill_kv_paged(params: Params, tokens: torch.Tensor, start: int,
                     hist_k: torch.Tensor, hist_v: torch.Tensor,
                     config: LlamaConfig):
    """Suffix prefill over a history: the prefix-cache hit path. tokens
    [1, Pb] sit at absolute positions start..start+Pb-1; hist_k/hist_v
    [L, S_pad, n_kv, head_dim] hold the cached prefix KV (rows >= start
    are don't-care: masked, then overwritten by the suffix). Returns
    (normed hidden [1, Pb, D], suffix ks/vs [L, 1, Pb, n_kv, head_dim]).

    Plain attention (``xla_attention`` over all S_pad keys with
    ``positions``), as in the reference: with start = 0 it is the same
    function as ``prefill_kv`` over a padded bucket, though not the same
    arithmetic as the flash kernel there. The reference's
    ``dynamic_update_slice`` clamps a suffix that runs past S_pad; the
    engine never asks for one (``hist_len + bucket <= max_seq_len``),
    and here it raises."""
    _dense_only(config)
    c = config
    B, Pb = tokens.shape
    S_pad = hist_k.shape[1]
    start = int(start)
    if B != 1:
        raise ValueError(f"prefill_kv_paged takes one sequence, got {B}")
    if start < 0 or start + Pb > S_pad:
        raise ValueError(f"suffix [{start}, {start + Pb}) runs past the "
                         f"history's {S_pad} rows")
    cos, sin = rope_freqs(c.head_dim, S_pad, c.rope_theta, tokens.device)
    qpos = torch.arange(start, start + Pb, device=tokens.device)
    cq, sq = cos[qpos], sin[qpos]
    rep = c.n_heads // c.n_kv_heads
    x = _embed(params, tokens, c.dtype)
    ks, vs = [], []
    for i, p in enumerate(_layer_views(params)):
        q, k, v = _qkv(x, p, c)
        q, k = apply_rope(q, cq, sq), apply_rope(k, cq, sq)
        keys, vals = hist_k[i].clone(), hist_v[i].clone()
        keys[start:start + Pb] = k[0].to(keys.dtype)
        vals[start:start + Pb] = v[0].to(vals.dtype)
        attn = xla_attention(
            q, _repeat_kv(keys[None].to(c.dtype), rep),
            _repeat_kv(vals[None].to(c.dtype), rep), causal=True,
            positions=qpos)
        x = x + attn.reshape(B, Pb, -1) @ _weight(p, "wo", c.dtype)
        x = _ffn(x, p, c)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["norm_f"], c.norm_eps)
    return x, torch.stack(ks), torch.stack(vs)


def prefill(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            max_len: Optional[int] = None):
    """Fill a fresh cache from a prompt [B, P] in one batched pass.
    Returns (last-token f32 logits [B, V], cache)."""
    c = config
    B, P = tokens.shape
    x, ks, vs = prefill_kv(params, tokens, config)
    logits = _logits(x[:, -1], params, c)
    cache = init_kv_cache(c, B, max_len or c.max_seq_len,
                          device=tokens.device)
    cache["k"][:, :, :P] = ks
    cache["v"][:, :, :P] = vs
    return logits, cache


def cache_len(n: int) -> int:
    """The cache length ``generate`` allocates for ``n`` positions: n
    rounded up to a multiple of 128. Masked rows add exact zeros, so the
    values are those of an n-row cache, but the decode attention's bf16
    products keep the aligned shapes an engine's cache has: cuBLAS takes
    another algorithm for a cache length that is not a multiple of 8, and
    its last bits then differ (on the H100 that broke greedy parity with
    the engine at a near-tie within 20 tokens of Llama-3-8B)."""
    return -(-n // 128) * 128


def generate(params: Params, prompt: torch.Tensor, config: LlamaConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (or temperature) generation: prompt [B, P] -> [B, N] int64.
    The reference also runs one decode step past the last token and
    discards it; this loop stops at the last token (same tokens)."""
    B, P = prompt.shape
    logits, cache = prefill(params, prompt, config,
                            max_len=cache_len(P + max_new_tokens))
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(0)
    toks = []
    for i in range(max_new_tokens):
        if temperature == 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        toks.append(tok)
        if i + 1 < max_new_tokens:
            pos = torch.full((B,), P + i, dtype=torch.long,
                             device=prompt.device)
            logits, cache = decode_step(params, cache, tok, pos, config)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# nn.Module view
# ---------------------------------------------------------------------------

_LAYER_PREFIX = "layers__"


class Llama(nn.Module):
    """A param tree as an ``nn.Module``: every tensor is a buffer (the
    serving path trains nothing), so ``.to()`` and ``state_dict()`` work
    as usual; ``params`` rebuilds the tree the functions above take."""

    def __init__(self, config: LlamaConfig, params: Params):
        super().__init__()
        self.config = config
        for name, t in params.items():
            if name == "layers":
                for lname, lt in t.items():
                    self.register_buffer(_LAYER_PREFIX + lname, lt)
            else:
                self.register_buffer(name, t)

    @classmethod
    def from_seed(cls, config: LlamaConfig, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "Llama":
        return cls(config, init_params(config, seed, device))

    @property
    def params(self) -> Params:
        out: Params = {"layers": {}}
        for name, t in self.named_buffers():
            if name.startswith(_LAYER_PREFIX):
                out["layers"][name[len(_LAYER_PREFIX):]] = t
            else:
                out[name] = t
        return out

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params, tokens, self.config)
