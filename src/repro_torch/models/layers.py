"""Elementary layers: norms, RoPE and sinusoidal positions, MLP variants, embeddings.

Functions over parameter dicts of torch tensors, as in the JAX package's
``models/layers.py``: master parameters stay float32 and are cast to the
compute dtype (``cfg.dtype``, bfloat16 on the card) at use.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16"), or a torch dtype as is."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(torch_dtype(dtype))


# ----------------------------------------------------------------- norms ---
def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


# ------------------------------------------------------------- positions ---
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy, as the JAX package computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S). Rotates (even, odd) pairs in float32."""
    d = x.shape[-1]
    inv = torch.tensor(rope_frequencies(d, theta), dtype=torch.float32, device=x.device)
    ang = positions[..., None].float() * inv            # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic transformer sinusoids in float32. positions: (..., S) -> (..., S, D).

    The frequencies are the JAX package's float64 numpy values rounded to float32.
    """
    half = d_model // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = positions[..., None].float() * torch.tensor(freq, dtype=torch.float32,
                                                      device=positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) times w (K, N) as one (rows, K) x (K, N) ``mm``: the
    product ``x @ w`` computes, the same bits.  DTensor's sharding
    propagation caches ``mm``; on the card's torch (2.11) it propagates
    ``matmul``'s decomposition anew on every call, which paces a sharded
    decode step."""
    if x.dim() == 2:
        return torch.mm(x, w)
    return torch.mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


# ------------------------------------------------------------------- mlp ---
def mlp_apply(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """x: (B, S, D); a sequence-split DTensor x is gathered first."""
    dt = x.dtype
    x = sharding.replicate_dim(x, 1)
    up = linear(x, cast(params["w_up"], dt))
    if mlp_type == "swiglu":
        h = F.silu(linear(x, cast(params["w_gate"], dt))) * up
    elif mlp_type == "geglu":
        h = F.gelu(linear(x, cast(params["w_gate"], dt)), approximate="tanh") * up
    elif mlp_type == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return linear(h, cast(params["w_down"], dt))


# ------------------------------------------------------------ embeddings ---
def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    table = cast(params["embedding"], dtype)
    if isinstance(table, DTensor):
        return _lookup_on_shards(tokens, table)
    return table[tokens]


def _masked_lookup(tokens, table, lo: int):
    """Rows ``tokens - lo`` of a table holding vocabulary rows [lo, lo + V'),
    zeros for tokens outside it."""
    rel = tokens - lo
    inside = (rel >= 0) & (rel < table.shape[0])
    rows = F.embedding(rel.clamp(0, table.shape[0] - 1), table)
    return rows * inside[..., None].to(rows.dtype)


def _lookup_on_shards(tokens, table):
    """The embedding lookup of DTensors.  A vocab-split table (tied
    embeddings) looks up each rank's own rows through ``local_map`` and sums
    the ranks' masked rows (one all-reduce of the activations), so the
    table never moves; its gradient comes back as each rank's rows, a
    partial sum over the tokens' batch axes.  (On the card's torch, 2.11,
    DTensor's own masked-partial rows cannot take their gradient back, and
    indexing's ``index_put`` backward mis-propagates.)  Otherwise
    ``F.embedding`` under DTensor's rule."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    split = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not split or any(p.is_shard(1) for p in table.placements):
        return F.embedding(tokens, table)
    coord = mesh.get_coordinate()
    index = 0
    for i in split:
        index = index * mesh.size(i) + coord[i]
    rows = table.shape[0] // math.prod(mesh.size(i) for i in split)
    tok = tokens.redistribute(mesh, [Replicate() if i in split else p
                                     for i, p in enumerate(tokens.placements)])
    out = [Partial() if i in split else Shard(0) if p.is_shard(0) else Replicate()
           for i, p in enumerate(tok.placements)]
    grad = [Shard(0) if i in split else Partial() if p.is_shard(0) else Replicate()
            for i, p in enumerate(tok.placements)]
    run = sharding.on_shards(_masked_lookup, mesh, (tok.placements, table.placements, None), out,
                             (tok.placements, grad, None))
    x = run(tok, table, index * rows)
    return x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])


def unembed_apply(params, x: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    table = params.get("unembed", params["embedding"])
    x = sharding.replicate_dim(x, 1)   # a sequence-split DTensor x is gathered first
    logits = linear(x, cast(table, x.dtype).t()).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------- init ---
class Init:
    """Draws parameters from the JAX package's distributions and scales.

    Normal draws come from one explicit `torch.Generator` on ``device``, so a
    seed gives the same weights on every run (not the JAX package's bits: a
    test carries those over with `repro_torch.convert`).  On the ``meta``
    device nothing is drawn: only shapes exist.
    """

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def normal(self, shape, std: float) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=torch.float32, device=self.device)
        out = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return out.mul_(std)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32, device=self.device)

    def tensor(self, values: np.ndarray) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=self.device)


def rmsnorm_init(init: Init, d: int) -> Dict:
    return {"scale": init.full((d,), 1.0)}


def mlp_init(init: Init, d_model: int, d_ff: int, mlp_type: str) -> Dict:
    p = {
        "w_up": init.normal((d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w_down": init.normal((d_ff, d_model), 1.0 / math.sqrt(d_ff)),
    }
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = init.normal((d_model, d_ff), 1.0 / math.sqrt(d_model))
    return p


def embed_init(init: Init, vocab: int, d_model: int, tie: bool) -> Dict:
    p = {"embedding": init.normal((vocab, d_model), 0.02)}
    if not tie:
        p["unembed"] = init.normal((vocab, d_model), 1.0 / math.sqrt(d_model))
    return p
