"""Mixture-of-Experts MLP: top-k routing with GShard-style capacity dispatch.

A port of the JAX package's ``models/moe.py``, in plain torch (no TPU
kernel computes it).

Train/prefill path: tokens are grouped by batch row; each row dispatches
its tokens into per-expert capacity buffers of ``cap`` slots.  Tokens
beyond capacity are dropped (GShard semantics).  Two dispatches compute the
same function: `moe_apply_onehot` (the one-hot einsum reference) and
`moe_apply_scatter` (an index assignment into the buffers and a gather
back), which ``moe_impl="shard_map"`` takes on plain tensors, as the JAX
package does with no mesh axes.  Each (expert, position) slot holds at most one token
and every dropped token goes to a sink row that is never read, so the
scatter is a plain index assignment: no atomics, the same bits every run.

Decode path: a dense mixture over the top-k experts' weights (every expert
computed for the one token, as in the JAX package).

`route` is the router both paths share: float32 gates from the router
logits computed in the activations' dtype, and the top k under the JAX
package's tie rule (``jax.lax.top_k``: of equal gates the lower expert
index first), which a stable descending sort gives on every device.

Aux loss: the Switch load-balancing loss, returned to the caller.

On a device mesh (a DTensor x, the sharded train step) every dispatch runs
token-local, `moe_apply_shardmap`: a ``local_map`` over the batch axes
(``cfg.act_shard_axes``) with the expert weights replicated, each rank
dispatching its own rows (the reference's ``shard_map`` and, for the other
dispatches, what its batch-sharding constraints ask GSPMD for).  The
``shard_map`` MoE averages the ranks' aux losses (the reference's
``pmean``); the others compute the aux loss of the whole batch from the
ranks' averaged token and gate shares.  The expert weights' gradients come
back as partial sums over the batch axes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import Init, cast, linear


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
    logits = linear(x, cast(params["router"], x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, cfg.top_k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return gates, topv, topi


def _expert_ffn(params, h, dt):
    """h: (B, E, C, D) -> (B, E, C, D) through each expert's SwiGLU."""
    g = torch.einsum("becd,edf->becf", h, cast(params["w_gate"], dt))
    u = torch.einsum("becd,edf->becf", h, cast(params["w_up"], dt))
    return torch.einsum("becf,efd->becd", F.silu(g) * u, cast(params["w_down"], dt))


def _shares(gates, topi, e: int):
    """(share of first choices, mean gate), each (E,), over the (B, S) tokens."""
    return F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1)), gates.mean(dim=(0, 1))


def _aux_loss(gates, topi, e: int):
    """Switch load balancing: E * sum_e (share of first choices) * (mean gate)."""
    frac_tokens, frac_probs = _shares(gates, topi, e)
    return e * torch.sum(frac_tokens * frac_probs)


def moe_apply(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux loss), by ``cfg.moe_impl``; a DTensor x
    token-local (`moe_apply_shardmap`)."""
    if isinstance(x, DTensor):
        return moe_apply_shardmap(params, x, cfg)
    if cfg.moe_impl in ("shard_map", "scatter"):
        return moe_apply_scatter(params, x, cfg)
    return moe_apply_onehot(params, x, cfg)


def _token_local(router, w_gate, w_up, w_down, x, cfg: ModelConfig, n: int):
    """One rank's rows through its dispatch -> (out, then each over ``n``
    ranks: the aux loss, the first-choice and gate shares)."""
    params = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    out, gates, topi = (_onehot if cfg.moe_impl == "onehot" else _scatter)(params, x, cfg)
    frac_tokens, frac_probs = _shares(gates, topi, cfg.n_experts)
    aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return out, aux / n, frac_tokens / n, frac_probs / n


def moe_apply_shardmap(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token-local MoE of a DTensor x (B, S, D): a ``local_map`` over the
    batch axes, x redistributed to rows split over them (the reference's
    ``_shard_batch``; replicated where they do not divide B), the expert
    weights replicated (gathered for the call; their gradients, partial sums
    over the row axes, go back to the weights' own placements at once).
    -> (out placed as those rows, aux loss)."""
    mesh = x.device_mesh
    spec = sharding.local_spec(mesh, cfg.act_shard_axes, x.shape[0], 3)
    sizes = sharding.axis_sizes(mesh)
    split = sharding.axes_of(spec[0])
    n = int(math.prod(sizes[a] for a in split))
    rows = sharding.placements(spec, mesh)
    whole = sharding.placements((), mesh)
    part = sharding.row_grads(spec, mesh)
    names = ("router", "w_gate", "w_up", "w_down")
    run = sharding.on_shards(_token_local, mesh, (whole,) * 4 + (rows, None, None),
                             (rows, part, part, part), (part,) * 4 + (rows, None, None))
    weights = (sharding.gathered(params[k], ()) for k in names)
    out, aux, frac_tokens, frac_probs = run(*weights, x, cfg, n)
    if cfg.moe_impl != "shard_map":
        aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_apply_grouped(params, x, cfg: ModelConfig, groups: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token-local MoE on one device: x's rows in ``groups`` equal
    groups, each through its own dispatch, as `moe_apply_shardmap` runs
    them on ``groups`` shards -> (out, aux), the aux loss combined as there.
    The function the sharded step computes, which holds it."""
    names = ("router", "w_gate", "w_up", "w_down")
    parts = [_token_local(*(params[k] for k in names), xg, cfg, groups)
             for xg in x.chunk(groups, 0)]
    out = torch.cat([p[0] for p in parts])
    aux, frac_tokens, frac_probs = (sum(p[i] for p in parts) for i in (1, 2, 3))
    if cfg.moe_impl != "shard_map":
        aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_apply_onehot(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot einsum dispatch, the reference formulation:
    O(T * E * C * D) dispatch work in (B, T, E, C) tensors."""
    out, gates, topi = _onehot(params, x, cfg)
    return out, _aux_loss(gates, topi, cfg.n_experts)


def _onehot(params, x, cfg: ModelConfig):
    """`moe_apply_onehot` -> (out, gates, top-k experts)."""
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
    return out.reshape(b, s, k, d).sum(dim=2), gates, topi


def moe_apply_scatter(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather capacity dispatch: the same tokens kept and dropped as
    `moe_apply_onehot` (the same position-in-expert order), the same outputs.

      slot = expert * C + position in expert      (a cumulative sum)
      buf[b, slot] = x                            (dropped tokens -> the sink row)
      out = expert_ffn(buf)[b, slot] * weight
    """
    out, gates, topi = _scatter(params, x, cfg)
    return out, _aux_loss(gates, topi, cfg.n_experts)


def _scatter(params, x, cfg: ModelConfig):
    """`moe_apply_scatter` -> (out, gates, top-k experts)."""
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
    return out.reshape(b, s, k, d).sum(dim=2), gates, topi


def moe_apply_decode(params, x, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, 1, D): a dense mixture over the top-k experts (every expert
    computed).  A DTensor x runs tensor-parallel (`_decode_on_shards`)."""
    if isinstance(x, DTensor):
        return _decode_on_shards(params, x, cfg)
    dt = x.dtype
    gates, topv, topi = route(params, x, cfg)
    mix = torch.zeros_like(gates).scatter_(-1, topi, topv)         # (B,S,E)
    g = torch.einsum("bsd,edf->bsef", x, cast(params["w_gate"], dt))
    u = torch.einsum("bsd,edf->bsef", x, cast(params["w_up"], dt))
    o = torch.einsum("bsef,efd->bsed", F.silu(g) * u, cast(params["w_down"], dt))
    return torch.einsum("bse,bsed->bsd", mix.to(dt), o)


def _decode_on_shards(params, x, cfg: ModelConfig):
    """`moe_apply_decode` of a DTensor x through ``local_map``: x's rows over
    the data axes (where they divide), the router whole, each expert's d_ff
    as w_down splits it (over ``model``: a rank computes its slab of every
    expert's FFN) -> the output as a partial sum over the axes that split
    d_ff, placed as those rows.  The expert weights never move (the train
    path's token-local MoE gathers them, which a decode step should not)."""
    mesh = x.device_mesh
    rows = sharding.local_spec(mesh, sharding.dp_axes(mesh), x.shape[0], 3)
    names = tuple(mesh.mesh_dim_names)
    f_axes = tuple(names[i] for i, p in enumerate(params["w_down"].placements) if p.is_shard(1))
    f = sharding._entry(f_axes)
    pl = sharding.placements
    gate, down = pl((None, None, f), mesh), pl((None, f, None), mesh)
    run = sharding.on_shards(_decode_local, mesh,
                             (pl((), mesh), gate, gate, down, pl(rows, mesh), None),
                             sharding.partial_over(rows, mesh, f_axes))
    return run(*(params[k] for k in _EXPERT_NAMES), x, cfg)


_EXPERT_NAMES = ("router", "w_gate", "w_up", "w_down")


def _decode_local(router, w_gate, w_up, w_down, x, cfg: ModelConfig):
    return moe_apply_decode(dict(zip(_EXPERT_NAMES, (router, w_gate, w_up, w_down))), x, cfg)
