"""Mixture-of-Experts layer: the port of ``ray_tpu/models/moe.py``.

The GShard/Switch dispatch as the reference writes it: router logits ->
top-k experts per token -> a capacity-masked one-hot dispatch tensor ->
three products (dispatch, the experts' SwiGLU FFN, combine). Every shape
is fixed by the token count and the capacity.

Kept from the reference, element for element:

- the router's logits are the compute-type product rounded, then f32; the
  probabilities their f32 softmax;
- top-k puts the lower expert index first among equal probabilities
  (``lax.top_k``'s order). ``torch.topk`` promises no order among ties,
  so the port takes the first k of a stable descending sort;
- queue positions are counted in integers, choice-major (every token's
  first choice before any second choice); a token past an expert's
  capacity C is dropped there (its combine weight is 0, so it passes
  through the residual only);
- the Switch load-balance term (eq. 4), ``E * sum_e f_e * p_e`` times
  ``router_aux_weight``, is taken from the assignment before capacity.

``dispatch`` is built by a scatter of ones in f32 rather than the
reference's int32 einsum (CUDA has no integer batched product): each
(token, expert) pair takes at most one slot, so the values are the same
0s and 1s. Experts sharded over a mesh's ``expert`` axis
(``moe_param_specs``) change no value on a virtual mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int
    hidden_dim: int          # per-expert FFN width
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    dtype: torch.dtype = torch.bfloat16

    def capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens * self.top_k
                  / self.n_experts)
        return max(cap, self.top_k)


def init_moe_params(cfg: MoEConfig, seed: int = 0,
                    param_dtype: torch.dtype = torch.float32,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Router [D, E] and expert weights [E, D, F], [E, D, F], [E, F, D],
    N(0, 1) scaled by fan-in^-1/2 as in the reference, drawn on
    ``device`` (default: the card) from a ``torch.Generator`` seeded with
    ``seed`` (the bits differ from the reference's; tests share weights
    through numpy)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, f, e = cfg.dim, cfg.hidden_dim, cfg.n_experts

    def normal(shape, scale):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return (t.normal_(0.0, 1.0, generator=gen) * scale).to(param_dtype)

    return {
        "router": normal((d, e), d ** -0.5),
        "w_gate": normal((e, d, f), d ** -0.5),
        "w_up": normal((e, d, f), d ** -0.5),
        "w_down": normal((e, f, d), f ** -0.5),
    }


def moe_param_specs():
    """Specs placing experts on the ``expert`` mesh axis (the router
    stays replicated)."""
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    return {
        "router": P(),
        "w_gate": P("expert", None, None),
        "w_up": P("expert", None, None),
        "w_down": P("expert", None, None),
    }


def top_k_stable(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, the lower index first
    among equals (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_dispatch(probs: torch.Tensor, k: int, capacity: int,
                    out_dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs [T, E] f32 -> (dispatch [T, E, C], combine [T, E, C],
    raw_assign [k, T, E] int32)."""
    T, E = probs.shape
    topk_probs, topk_idx = top_k_stable(probs, k)           # [T, k]
    assign_raw = F.one_hot(topk_idx.t(), E).to(torch.int32)  # [k, T, E]
    flat = assign_raw.reshape(k * T, E)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, T, E)
    assign = assign_raw * (pos < capacity)
    slot = (pos * assign).sum(dim=-1)                        # [k, T]
    kept = assign.sum(dim=-1).to(torch.float32)              # [k, T] 0/1
    # dispatch[t, e, c] = 1 iff token t occupies slot c of expert e: a
    # token's k choices are distinct experts, so no two ones collide; a
    # dropped choice adds 0 at its expert's slot 0.
    cell = topk_idx.t() * capacity + slot                    # [k, T]
    dispatch = torch.zeros((T, E * capacity), dtype=torch.float32,
                           device=probs.device)
    dispatch.scatter_add_(1, cell.t(), kept.t())
    dispatch = dispatch.reshape(T, E, capacity).to(out_dtype)
    weight = (assign.to(torch.float32)
              * topk_probs.t()[..., None]).sum(dim=0)       # [T, E]
    combine = dispatch * weight[..., None].to(out_dtype)
    return dispatch, combine, assign_raw


def moe_layer(x: torch.Tensor, params: Dict[str, torch.Tensor],
              cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux scalar f32)."""
    B, S, D = x.shape
    T = B * S
    C = cfg.capacity(T)
    xt = x.reshape(T, D)

    logits = (xt @ params["router"].to(cfg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # [T, E]
    dispatch, combine, assign_raw = _top_k_dispatch(
        probs, cfg.top_k, C, cfg.dtype)

    frac_tokens = assign_raw.to(torch.float32).mean(dim=(0, 1)) * cfg.top_k
    frac_probs = probs.mean(dim=0)
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum() \
        * cfg.router_aux_weight

    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)    # [E, C, D]
    gate = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                               params["w_gate"].to(cfg.dtype)))
    up = torch.einsum("ecd,edf->ecf", expert_in,
                      params["w_up"].to(cfg.dtype))
    expert_out = torch.einsum("ecf,efd->ecd", gate * up,
                              params["w_down"].to(cfg.dtype))
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.reshape(B, S, D), aux
