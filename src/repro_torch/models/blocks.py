"""Pre-norm residual blocks of every family.

Ports of the JAX package's ``models/blocks.py``:

  * ``attn_mlp`` — self-attention + MLP (dense, the encoder, the shared
    Zamba block);
  * ``moe``      — self-attention + the MoE MLP;
  * ``cross``    — cross-attention (+ MLP) of the VLM and the enc-dec decoder;
  * ``mamba``    — the Mamba-2 block.

``use_kernel`` selects the hand-written kernels' path for self-attention
and the SSD scan (`attention.attend_full`, `ssm.mamba2_apply`);
cross-attention is plain torch either way.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init, cast, mlp_apply, mlp_init, rmsnorm, rmsnorm_init


# ------------------------------------------------------------- attn + mlp ---
def attn_mlp_init(init: Init, cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": rmsnorm_init(init, cfg.d_model),
        "attn": attn.attn_init(init, cfg),
        "ln_mlp": rmsnorm_init(init, cfg.d_model),
        "mlp": mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp_type),
    }


def attn_mlp_apply(params, x, cfg: ModelConfig, positions=None, causal=True,
                   return_kv=False, use_kernel=True):
    res = attn.attend_full(params["attn"], rmsnorm(params["ln_attn"], x), cfg,
                           positions=positions, causal=causal, return_kv=return_kv,
                           use_kernel=use_kernel)
    h, kv = res if return_kv else (res, None)
    x = x + h
    x = x + mlp_apply(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return (x, kv) if return_kv else x


def attn_mlp_decode(params, x, cache, pos, cfg: ModelConfig):
    h, cache = attn.attend_decode(params["attn"], rmsnorm(params["ln_attn"], x), cache, pos,
                                  cfg)
    x = x + h
    return x + mlp_apply(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type), cache


# ------------------------------------------------------------------- moe ---
def moe_block_init(init: Init, cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": rmsnorm_init(init, cfg.d_model),
        "attn": attn.attn_init(init, cfg),
        "ln_mlp": rmsnorm_init(init, cfg.d_model),
        "moe": moe_mod.moe_init(init, cfg),
    }


def moe_block_apply(params, x, cfg: ModelConfig, return_kv=False, use_kernel=True):
    """-> (x, aux) or, with ``return_kv``, (x, aux, (k, v))."""
    res = attn.attend_full(params["attn"], rmsnorm(params["ln_attn"], x), cfg,
                           return_kv=return_kv, use_kernel=use_kernel)
    h, kv = res if return_kv else (res, None)
    x = x + h
    h, aux = moe_mod.moe_apply(params["moe"], rmsnorm(params["ln_mlp"], x), cfg)
    x = x + h
    return (x, aux, kv) if return_kv else (x, aux)


def moe_block_decode(params, x, cache, pos, cfg: ModelConfig):
    h, cache = attn.attend_decode(params["attn"], rmsnorm(params["ln_attn"], x), cache, pos,
                                  cfg)
    x = x + h
    return x + moe_mod.moe_apply_decode(params["moe"], rmsnorm(params["ln_mlp"], x), cfg), cache


# ------------------------------------------------- cross-attention blocks ---
def cross_block_init(init: Init, cfg: ModelConfig, with_mlp: bool = True) -> Dict:
    p = {"ln_x": rmsnorm_init(init, cfg.d_model), "cross": attn.cross_attn_init(init, cfg)}
    if with_mlp:
        p["ln_mlp"] = rmsnorm_init(init, cfg.d_model)
        p["mlp"] = mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return p


def _cross_mlp(params, x, cfg: ModelConfig):
    if "mlp" in params:
        x = x + mlp_apply(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return x


def cross_block_apply(params, x, context, cfg: ModelConfig):
    x = x + attn.attend_cross(params["cross"], rmsnorm(params["ln_x"], x), context, cfg)
    return _cross_mlp(params, x, cfg)


def cross_block_decode_cached(params, x, ck, cv, cfg: ModelConfig):
    """Cross-attention against the context's cached K/V (B, T, Hkv, Dh)."""
    dt = x.dtype
    b, s, _ = x.shape
    dh = cfg.head_dim
    xq = rmsnorm(params["ln_x"], x)
    q = (xq @ cast(params["cross"]["w_q"], dt)).reshape(b, s, cfg.n_heads, dh)
    if cfg.qkv_bias:
        q = q + cast(params["cross"]["b_q"], dt).reshape(cfg.n_heads, dh)
    # A division, where attend_cross multiplies by the reciprocal: as the JAX
    # package rounds it.
    logits = attn._gqa_scores(q, ck) / math.sqrt(dh)
    o = attn._gqa_out(torch.softmax(logits, dim=-1), cv, b, s, cfg.n_heads, dh)
    x = x + torch.matmul(*attn._promoted(o, cast(params["cross"]["w_o"], dt)))
    return _cross_mlp(params, x, cfg)


def cross_context_kv(params, context, cfg: ModelConfig):
    """The cross-attention K/V of ``context`` (B, T, D), computed once at prefill."""
    dt = context.dtype
    b, t, _ = context.shape
    dh = cfg.head_dim
    k = (context @ cast(params["cross"]["w_k"], dt)).reshape(b, t, cfg.n_kv_heads, dh)
    v = (context @ cast(params["cross"]["w_v"], dt)).reshape(b, t, cfg.n_kv_heads, dh)
    if cfg.qkv_bias:
        k = k + cast(params["cross"]["b_k"], dt).reshape(cfg.n_kv_heads, dh)
        v = v + cast(params["cross"]["b_v"], dt).reshape(cfg.n_kv_heads, dh)
    return k, v


# ----------------------------------------------------------------- mamba ---
def mamba_block_init(init: Init, cfg: ModelConfig) -> Dict:
    return {"ln": rmsnorm_init(init, cfg.d_model), "mamba": ssm_mod.mamba2_init(init, cfg)}


def mamba_block_apply(params, x, cfg: ModelConfig, return_state=False, use_kernel=True):
    res = ssm_mod.mamba2_apply(params["mamba"], rmsnorm(params["ln"], x), cfg,
                               return_state=return_state, use_kernel=use_kernel)
    if return_state:
        h, st = res
        return x + h, st
    return x + res


def mamba_block_decode(params, x, state, cfg: ModelConfig):
    h, state = ssm_mod.mamba2_decode(params["mamba"], rmsnorm(params["ln"], x), state, cfg)
    return x + h, state
