"""Mixture-of-Experts MLP: top-k routing with GShard-style capacity dispatch.

A port of the JAX package's ``models/moe.py``, in plain torch (no TPU
kernel computes it).

Train/prefill path: tokens are grouped by batch row; each row dispatches
its tokens into per-expert capacity buffers of ``cap`` slots.  Tokens
beyond capacity are dropped (GShard semantics).  Two dispatches compute the
same function: `moe_apply_onehot` (the one-hot einsum reference) and
`moe_apply_scatter` (an index assignment into the buffers and a gather
back), which ``moe_impl="shard_map"`` takes here, as the JAX package does
with no mesh axes.  Each (expert, position) slot holds at most one token
and every dropped token goes to a sink row that is never read, so the
scatter is a plain index assignment: no atomics, the same bits every run.

Decode path: a dense mixture over the top-k experts' weights (every expert
computed for the one token, as in the JAX package).

`route` is the router both paths share: float32 gates from the router
logits computed in the activations' dtype, and the top k under the JAX
package's tie rule (``jax.lax.top_k``: of equal gates the lower expert
index first), which a stable descending sort gives on every device.

Aux loss: the Switch load-balancing loss, returned to the caller.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Init, cast


def moe_init(init: Init, cfg: ModelConfig) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": init.normal((d, e), s_in),
        "w_gate": init.normal((e, d, f), s_in),
        "w_up": init.normal((e, d, f), s_in),
        "w_down": init.normal((e, f, d), s_out),
    }


def _capacity(s: int, cfg: ModelConfig) -> int:
    k = cfg.top_k
    return min(int(math.ceil(s * k * cfg.capacity_factor / cfg.n_experts)), s * k)


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates along the last axis and their indices, in
    descending order, equal gates by the lower index first."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (gates (B,S,E) float32, renormalized top-k weights
    (B,S,k) float32, top-k experts (B,S,k))."""
    logits = (x @ cast(params["router"], x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, cfg.top_k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return gates, topv, topi


def _expert_ffn(params, h, dt):
    """h: (B, E, C, D) -> (B, E, C, D) through each expert's SwiGLU."""
    g = torch.einsum("becd,edf->becf", h, cast(params["w_gate"], dt))
    u = torch.einsum("becd,edf->becf", h, cast(params["w_up"], dt))
    return torch.einsum("becf,efd->becd", F.silu(g) * u, cast(params["w_down"], dt))


def _aux_loss(gates, topi, e: int):
    """Switch load balancing: E * sum_e (share of first choices) * (mean gate)."""
    frac_tokens = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
    return e * torch.sum(frac_tokens * gates.mean(dim=(0, 1)))


def moe_apply(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss), by ``cfg.moe_impl``."""
    if cfg.moe_impl in ("shard_map", "scatter"):
        if cfg.act_shard_axes:
            raise NotImplementedError("sharded MoE waits for the LM sharding rules "
                                      "(ROADMAP queue 1 item 2.5)")
        return moe_apply_scatter(params, x, cfg)
    return moe_apply_onehot(params, x, cfg)


def moe_apply_onehot(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot einsum dispatch, the reference formulation:
    O(T * E * C * D) dispatch work in (B, T, E, C) tensors."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    gates, topv, topi = route(params, x, cfg)
    t = s * k                                                       # (token, slot) pairs
    onehot = F.one_hot(topi.reshape(b, t), e).float()               # (B,T,E)
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    pos = torch.clamp(pos, 0, cap - 1).long()
    slot_oh = F.one_hot(pos, cap).float() * keep[..., None]
    dispatch = (onehot[..., None] * slot_oh).to(dt)                 # (B,T,E,C)
    x_slots = torch.repeat_interleave(x, k, dim=1)                  # (B,T,D)
    h = _expert_ffn(params, torch.einsum("btec,btd->becd", dispatch, x_slots), dt)
    combine = dispatch * topv.reshape(b, t)[..., None, None].to(dt)
    out = torch.einsum("btec,becd->btd", combine, h)
    return out.reshape(b, s, k, d).sum(dim=2), _aux_loss(gates, topi, e)


def moe_apply_scatter(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather capacity dispatch: the same tokens kept and dropped as
    `moe_apply_onehot` (the same position-in-expert order), the same outputs.

      slot = expert * C + position in expert      (a cumulative sum)
      buf[b, slot] = x                            (dropped tokens -> the sink row)
      out = expert_ffn(buf)[b, slot] * weight
    """
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    gates, topv, topi = route(params, x, cfg)
    t = s * k
    sel = topi.reshape(b, t)
    onehot = F.one_hot(sel, e).float()
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1.0      # (B,T)
    keep = (pos >= 0) & (pos < cap)
    slot = torch.where(keep, sel * cap + pos.long(), e * cap)
    bidx = torch.arange(b, device=x.device)[:, None]
    buf = torch.zeros((b, e * cap + 1, d), dtype=dt, device=x.device)
    buf[bidx, slot] = torch.repeat_interleave(x, k, dim=1) * keep[..., None].to(dt)
    h = _expert_ffn(params, buf[:, :e * cap].reshape(b, e, cap, d), dt)
    y = torch.cat([h.reshape(b, e * cap, d), torch.zeros((b, 1, d), dtype=dt,
                                                          device=x.device)], dim=1)
    out = y[bidx, slot] * (topv.reshape(b, t).to(dt) * keep.to(dt))[..., None]
    return out.reshape(b, s, k, d).sum(dim=2), _aux_loss(gates, topi, e)


def moe_apply_decode(params, x, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, 1, D): a dense mixture over the top-k experts (every expert computed)."""
    dt = x.dtype
    gates, topv, topi = route(params, x, cfg)
    mix = torch.zeros_like(gates).scatter_(-1, topi, topv)         # (B,S,E)
    g = torch.einsum("bsd,edf->bsef", x, cast(params["w_gate"], dt))
    u = torch.einsum("bsd,edf->bsef", x, cast(params["w_up"], dt))
    o = torch.einsum("bsef,efd->bsed", F.silu(g) * u, cast(params["w_down"], dt))
    return torch.einsum("bse,bsed->bsd", mix.to(dt), o)
