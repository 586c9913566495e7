"""Attention: MHA/GQA/MQA with RoPE, sliding window, a KV cache, cross-attention.

Ports of the JAX package's ``models/attention.py``:

  * ``attend_full``   — prefill / teacher-forced self-attention.  With
    ``use_kernel`` (the default) it runs `kernels.attention.ops.
    flash_attention`, which launches ``csrc/flash.cu`` on the card and its
    plain version on the CPU (under grad, its autograd Function: the
    forward kernel with the LSE and the backward kernels); without,
    it runs the JAX package's dense path (bf16 einsum logits, softmax), the
    plain path the card's run is held against.
  * ``attend_decode`` — one-token decode against the (B, T, Hkv, D) cache,
    plain torch as in the JAX package.  It writes the new key and value into
    the cache in place at ``pos`` (the JAX package returns a new cache).
  * ``attend_cross``  — decoder -> encoder / text -> image attention, no
    mask.  Plain torch einsums, as in the JAX package (no TPU kernel
    computes it; the flash kernel is self-attention, q and kv of one length).

Operands of two dtypes (gemma's float32 residual stream against its bf16
KV cache) are promoted as JAX promotes them: to the wider dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.models.layers import Init, apply_rope, cast, torch_dtype

NEG_INF = -1e30


def attn_init(init: Init, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    dh = cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "w_q": init.normal((d, cfg.n_heads * dh), s),
        "w_k": init.normal((d, cfg.n_kv_heads * dh), s),
        "w_v": init.normal((d, cfg.n_kv_heads * dh), s),
        "w_o": init.normal((cfg.n_heads * dh, d), 1.0 / math.sqrt(cfg.n_heads * dh)),
    }
    if cfg.qkv_bias:
        for name, width in (("b_q", cfg.n_heads), ("b_k", cfg.n_kv_heads), ("b_v", cfg.n_kv_heads)):
            p[name] = init.full((width * dh,), 0.0)
    return p


def _project_qkv(params, x, cfg: ModelConfig):
    dt = x.dtype
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = x @ cast(params["w_q"], dt)
    k = x @ cast(params["w_k"], dt)
    v = x @ cast(params["w_v"], dt)
    if cfg.qkv_bias:
        q = q + cast(params["b_q"], dt)
        k = k + cast(params["b_k"], dt)
        v = v + cast(params["b_v"], dt)
    return (q.reshape(b, s, cfg.n_heads, dh), k.reshape(b, s, cfg.n_kv_heads, dh),
            v.reshape(b, s, cfg.n_kv_heads, dh))


def _promoted(a, b):
    """a and b in the dtype JAX would compute ``a op b`` in."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _gqa_scores(q, k):
    """q: (B,S,Hq,D), k: (B,T,Hkv,D) -> float32 logits (B,Hkv,G,S,T), from the
    operands' promoted dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg, k = _promoted(q.reshape(b, s, hkv, hq // hkv, d), k)
    return torch.einsum("bskgd,btkd->bkgst", qg, k).float()


def _gqa_out(p, v, b, s, hq, d):
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return o.reshape(b, s, hq * d)


def attend_full(params, x, cfg: ModelConfig, positions=None, causal: bool = True,
                use_rope: bool = True, return_kv: bool = False, use_kernel: bool = True):
    """Self-attention over full sequences; x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    pos = positions if positions is not None else torch.arange(s, device=x.device)[None, :]
    if use_rope and cfg.pos_embed == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if use_kernel:
        if positions is not None:
            raise ValueError("the flash path masks by index: positions must be arange(S)")
        # (B, S, H, D) seen as (B, H, S, D); the output keeps q's layout.
        o = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal, cfg.sliding_window, 1.0 / math.sqrt(cfg.head_dim))
        o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    else:
        logits = _gqa_scores(q, k) * (1.0 / math.sqrt(cfg.head_dim))   # (B,Hkv,G,S,T)
        qi = pos[:, None, None, :, None]
        ki = pos[:, None, None, None, :]
        mask = torch.ones((b, 1, 1, s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask &= ki <= qi
        if cfg.sliding_window is not None:
            mask &= ki > qi - cfg.sliding_window
        logits = torch.where(mask, logits, NEG_INF)
        o = _gqa_out(torch.softmax(logits, dim=-1), v, b, s, cfg.n_heads, cfg.head_dim)
    out = o @ cast(params["w_o"], x.dtype)
    return (out, (k, v)) if return_kv else out


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attend_decode(params, x, cache: Dict, pos: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token decode; x: (B, 1, D).  Writes the token's key and value into
    ``cache`` ({"k", "v"}: (B, T, Hkv, D)) at ``pos`` and attends over 0..pos."""
    b = x.shape[0]
    dh = cfg.head_dim
    q, k_new, v_new = _project_qkv(params, x, cfg)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    t = k.shape[1]
    logits = _gqa_scores(q, k) * (1.0 / math.sqrt(dh))   # (B,Hkv,G,1,T)
    ki = torch.arange(t, device=x.device)[None, None, None, None, :]
    mask = ki <= pos
    if cfg.sliding_window is not None:
        mask &= ki > pos - cfg.sliding_window
    logits = torch.where(mask, logits, NEG_INF)
    o = _gqa_out(torch.softmax(logits, dim=-1), v, b, 1, cfg.n_heads, dh)
    return torch.matmul(*_promoted(o, cast(params["w_o"], x.dtype))), cache


def cross_attn_init(init: Init, cfg: ModelConfig) -> Dict:
    return attn_init(init, cfg)


def attend_cross(params, x, context, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,D) queries; context: (B,T,D) keys and values (no masking)."""
    dt = x.dtype
    b, s, _ = x.shape
    t = context.shape[1]
    dh = cfg.head_dim
    q = (x @ cast(params["w_q"], dt)).reshape(b, s, cfg.n_heads, dh)
    k = (context @ cast(params["w_k"], dt)).reshape(b, t, cfg.n_kv_heads, dh)
    v = (context @ cast(params["w_v"], dt)).reshape(b, t, cfg.n_kv_heads, dh)
    if cfg.qkv_bias:
        q = q + cast(params["b_q"], dt).reshape(cfg.n_heads, dh)
        k = k + cast(params["b_k"], dt).reshape(cfg.n_kv_heads, dh)
        v = v + cast(params["b_v"], dt).reshape(cfg.n_kv_heads, dh)
    logits = _gqa_scores(q, k) * (1.0 / math.sqrt(dh))
    o = _gqa_out(torch.softmax(logits, dim=-1), v, b, s, cfg.n_heads, dh)
    return o @ cast(params["w_o"], dt)
