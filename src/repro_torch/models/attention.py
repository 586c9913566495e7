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
    the cache in place at ``pos`` (the JAX package returns a new cache).  A
    DTensor cache split over T is written by the rank holding ``pos`` and
    read on each rank's slab, the partial softmaxes combined by two
    all-reduces (`cached_attention`), never gathered.
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
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.models.layers import Init, apply_rope, cast, linear, torch_dtype

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
    q = linear(x, cast(params["w_q"], dt))
    k = linear(x, cast(params["w_k"], dt))
    v = linear(x, cast(params["w_v"], dt))
    if cfg.qkv_bias:
        q = sharding.reduced(q) + cast(params["b_q"], dt)
        k = sharding.reduced(k) + cast(params["b_k"], dt)
        v = sharding.reduced(v) + cast(params["b_v"], dt)
    return (sharding.split_last(q, cfg.n_heads), sharding.split_last(k, cfg.n_kv_heads),
            sharding.split_last(v, cfg.n_kv_heads))


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
    """Self-attention over full sequences; x: (B, S, D) -> (B, S, D).  A
    sequence-split DTensor x (sequence-parallel activations) is gathered
    first."""
    b, s, _ = x.shape
    x = sharding.replicate_dim(x, 1)
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
                                      causal, cfg.sliding_window, 1.0 / math.sqrt(cfg.head_dim),
                                      batch_axes=cfg.act_shard_axes)
        o = sharding.pin_grad(o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim))
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
    out = linear(o, cast(params["w_o"], x.dtype))
    return (out, (k, v)) if return_kv else out


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attend_decode(params, x, cache: Dict, pos: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token decode; x: (B, 1, D).  Writes the token's key and value into
    ``cache`` ({"k", "v"}: (B, T, Hkv, D)) at ``pos`` and attends over 0..pos.
    A DTensor cache is written and read on each rank's shard
    (`sharding.write_layer`, `cached_attention`)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    if isinstance(k, DTensor):
        sharding.write_slab(k, k_new, dim=1, start=pos)
        sharding.write_slab(v, v_new, dim=1, start=pos)
    else:
        k[:, pos] = k_new[:, 0].to(k.dtype)
        v[:, pos] = v_new[:, 0].to(v.dtype)
    o = cached_attention(q, k, v, 1.0 / math.sqrt(cfg.head_dim), pos, cfg.sliding_window)
    return linear(*_promoted(o, cast(params["w_o"], x.dtype))), cache


def _attend_cache(q, k, v, scale, pos, window, k0: int = 0, divide: bool = False):
    """Softmax attention of q (B,1,Hq,D) over k, v (B,T,Hkv,D) holding the
    positions [k0, k0 + T) -> (B, 1, Hq*D): float32 logits times ``scale``
    (divided by it with ``divide``), keys after ``pos`` or outside the
    sliding window masked (no mask for None), the softmax's P rounded to v's
    dtype."""
    b, s, hq, d = q.shape
    logits = _masked_logits(q, k, scale, pos, window, k0, divide)
    return _gqa_out(torch.softmax(logits, dim=-1), v, b, s, hq, d)


def _masked_logits(q, k, scale, pos, window, k0: int, divide: bool):
    """`_attend_cache`'s float32 logits (B,Hkv,G,1,T) over the keys of
    positions [k0, k0 + T), scaled and masked."""
    logits = _gqa_scores(q, k)
    logits = logits / scale if divide else logits * scale
    if pos is not None:
        ki = torch.arange(k0, k0 + k.shape[1], device=q.device)[None, None, None, None, :]
        mask = ki <= pos
        if window is not None:
            mask &= ki > pos - window
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def cached_attention(q, k, v, scale: float, pos=None, window=None, divide: bool = False):
    """`_attend_cache` of one query token over a cache.  A DTensor cache
    (split over T, and B, by `sharding.cache_pspecs`) runs on each rank's
    shard: q's rows are taken as the cache's (heads whole), each rank
    attends over its own slab of T, and where T is split the ranks' partial
    softmaxes are combined, a max and then the sums of P and of P V
    reduced over T's ranks in float32 (GSPMD's partition of the
    reference's softmax; the cache never moves).  -> DTensor rows as the
    cache's."""
    from torch.distributed.tensor import Replicate, Shard

    if not isinstance(k, DTensor):
        return _attend_cache(q, k, v, scale, pos, window, divide=divide)
    mesh = k.device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in k.placements]
    ql = q.redistribute(mesh, rows).to_local()
    kl, vl = k.to_local(), v.to_local()
    k0, _ = sharding.slab(k, 1)
    group = sharding.split_group(k, 1)
    b, s, hq, d = ql.shape
    if group is None:
        o = _attend_cache(ql, kl, vl, scale, pos, window, k0, divide)
    else:
        logits = _masked_logits(ql, kl, scale, pos, window, k0, divide)
        m = sharding.all_reduce(logits.amax(-1, keepdim=True), "max", group)
        p = torch.exp(logits - m)
        acc = torch.einsum("bkgst,btkd->bskgd", p, vl.float()).reshape(b, s, hq * d)
        both = sharding.all_reduce(torch.cat([acc.reshape(b, -1), p.sum(-1).reshape(b, -1)], 1),
                                   "sum", group)
        acc, denom = both[:, :s * hq * d], both[:, s * hq * d:]
        # denom is (B, Hkv, G, S): each q head's sum, in the (S, Hq) order of acc.
        denom = denom.reshape(b, -1, s).transpose(1, 2).reshape(b, s, hq)
        o = (acc.reshape(b, s, hq, d) / denom[..., None]).reshape(b, s, hq * d).to(vl.dtype)
    return DTensor.from_local(o, mesh, rows, run_check=False, shape=(k.shape[0], s, hq * d),
                              stride=(s * hq * d, hq * d, 1))


def cross_attn_init(init: Init, cfg: ModelConfig) -> Dict:
    return attn_init(init, cfg)


def attend_cross(params, x, context, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,D) queries; context: (B,T,D) keys and values (no masking)."""
    dt = x.dtype
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = sharding.split_last(linear(x, cast(params["w_q"], dt)), cfg.n_heads)
    k = sharding.split_last(linear(context, cast(params["w_k"], dt)), cfg.n_kv_heads)
    v = sharding.split_last(linear(context, cast(params["w_v"], dt)), cfg.n_kv_heads)
    if cfg.qkv_bias:
        q = q + cast(params["b_q"], dt).reshape(cfg.n_heads, dh)
        k = k + cast(params["b_k"], dt).reshape(cfg.n_kv_heads, dh)
        v = v + cast(params["b_v"], dt).reshape(cfg.n_kv_heads, dh)
    logits = _gqa_scores(q, k) * (1.0 / math.sqrt(dh))
    o = _gqa_out(torch.softmax(logits, dim=-1), v, b, s, cfg.n_heads, dh)
    return linear(sharding.pin_grad(o), cast(params["w_o"], dt))
