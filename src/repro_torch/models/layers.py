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


# ------------------------------------------------------------------- mlp ---
def mlp_apply(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    dt = x.dtype
    up = x @ cast(params["w_up"], dt)
    if mlp_type == "swiglu":
        h = F.silu(x @ cast(params["w_gate"], dt)) * up
    elif mlp_type == "geglu":
        h = F.gelu(x @ cast(params["w_gate"], dt), approximate="tanh") * up
    elif mlp_type == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ cast(params["w_down"], dt)


# ------------------------------------------------------------ embeddings ---
def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return cast(params["embedding"], dtype)[tokens]


def unembed_apply(params, x: torch.Tensor, softcap: Optional[float] = None) -> torch.Tensor:
    table = params.get("unembed", params["embedding"])
    logits = (x @ cast(table, x.dtype).T).float()
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
