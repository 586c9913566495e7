"""Mamba-2 (SSD) block: prefill and decode paths.

A port of the JAX package's ``models/ssm.py``: fused in_proj -> [z | x | B |
C | dt], depthwise causal conv over [x|B|C], SiLU, SSD with scalar-identity
A per head, D skip, SiLU(z) gating, RMSNorm, out_proj.

``mamba2_apply`` runs the chunked scan through `kernels.ssd.ops.ssd_log`
(``use_kernel``, the default): ``csrc/ssd.cu`` on the card, its plain
version on the CPU (under grad the backward kernels on the card,
autograd through the plain version on the CPU).  Without ``use_kernel`` it runs
`_ssd_chunked`, the JAX package's plain chunked form.  ``mamba2_decode`` is the raw one-token
recurrence in plain torch, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.models.layers import Init, cast, linear, rmsnorm, rmsnorm_init, torch_dtype


def mamba2_init(init: Init, cfg: ModelConfig) -> Dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    return {
        "in_proj": init.normal((d, 2 * di + 2 * n + h), 1.0 / math.sqrt(d)),
        "conv_w": init.normal((cfg.conv_width, conv_ch), 0.1),
        "conv_b": init.full((conv_ch,), 0.0),
        "A_log": init.tensor(np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))),
        "D": init.full((h,), 1.0),
        "dt_bias": init.full((h,), 0.0),
        "norm": rmsnorm_init(init, di),
        "out_proj": init.normal((di, d), 1.0 / math.sqrt(di)),
    }


def _split_proj(proj, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    assert dt.shape[-1] == cfg.n_ssm_heads
    return z, xbc, dt


def _causal_conv(xbc, w, b, batch_axes=()):
    """Depthwise causal conv, width W. xbc: (B,S,C); w: (W,C).  A DTensor
    xbc runs on its local rows (`_conv_on_shards`)."""
    if isinstance(xbc, DTensor):
        return _conv_on_shards(xbc, w, b, batch_axes)
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return out + b


def _conv_on_shards(xbc, w, b, batch_axes):
    """The causal conv of a DTensor through ``local_map``: rows split over
    ``batch_axes`` (where they divide), channels and taps whole, so each
    rank convolves its own rows; the taps' and bias's gradients come back
    as partial sums over the rows' axes."""
    mesh = xbc.device_mesh
    spec = sharding.local_spec(mesh, batch_axes, xbc.shape[0], 3)
    rows, whole = sharding.placements(spec, mesh), sharding.placements((), mesh)
    part = sharding.row_grads(spec, mesh)
    return sharding.on_shards(_causal_conv, mesh, (rows, whole, whole), rows,
                              (rows, part, part))(xbc, w, b)


def softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)), with no threshold: torch's has one at 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssd_chunked(log_a, Bm, Cm, x, chunk: int, return_state: bool = False,
                 intra_dtype: str = "float32"):
    """The plain chunked SSD in log space (the JAX package's ``_ssd_chunked``).

    log_a: (B,S,H) log-decay (<= 0), kept in log space because the decay
    itself underflows float32 for large dt*|A|.  Bm/Cm: (B,S,N); x: (B,S,H,P).
    Returns y (B,S,H,P) float32, and with ``return_state`` the state after
    the last token, (B,H,N,P) float32.
    """
    y, state = ssd_chunked_ref(log_a, Bm, Cm, x, chunk, intra_dtype)
    return (y, state) if return_state else y


def mamba2_apply(params, u, cfg: ModelConfig, return_state: bool = False,
                 use_kernel: bool = True):
    """u: (B, S, D) -> (B, S, D).  Prefill path.

    With ``return_state`` also returns {"conv", "ssm"}: the states a decode
    loop holds after consuming the sequence (prefill -> decode handoff).
    """
    dt_ = u.dtype
    b, s, _ = u.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    # On a mesh in_proj's columns are split over "model" across the z | x |
    # B | C | dt boundaries: gather them before the split.
    proj = sharding.replicate_dim(linear(u, cast(params["in_proj"], dt_)), -1)
    z, xbc_raw, dtv = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc_raw, cast(params["conv_w"], dt_), cast(params["conv_b"], dt_),
                       cfg.act_shard_axes)
    xbc = F.silu(xbc)
    xh = xbc[..., :di].reshape(b, s, h, p)
    Bm = xbc[..., di:di + n]
    Cm = xbc[..., di + n:]
    dt_act = softplus(dtv.float() + params["dt_bias"])                 # (B,S,H)
    log_a = -torch.exp(params["A_log"]) * dt_act                        # (B,S,H), <= 0
    x_in = xh * dt_act[..., None].to(dt_)
    if use_kernel:
        y, s_final = ssd_ops.ssd_log(log_a, Bm, Cm, x_in, cfg.ssm_chunk, cfg.ssd_intra_dtype,
                                     batch_axes=cfg.act_shard_axes)
    else:
        y, s_final = _ssd_chunked(log_a, Bm, Cm, x_in, cfg.ssm_chunk, return_state=True,
                                  intra_dtype=cfg.ssd_intra_dtype)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y)
    out = linear(y, cast(params["out_proj"], dt_))
    if not return_state:
        return out
    w = cfg.conv_width
    if s >= w - 1:
        conv_state = xbc_raw[:, s - (w - 1):, :]
    else:
        conv_state = F.pad(xbc_raw, (0, 0, w - 1 - s, 0))
    return out, {"conv": conv_state, "ssm": s_final}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    di, n = cfg.d_inner, cfg.ssm_state
    h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n), dtype=torch_dtype(dtype),
                            device=device),
        "ssm": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
    }


def mamba2_decode(params, u, state: Dict, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """u: (B, 1, D); advances the conv buffer and SSM state one token.

    Returns the output and new {"conv", "ssm"} tensors (the caller stores
    them).  DTensor states run on each rank's shard (`_decode_on_shards`).
    """
    if isinstance(state["ssm"], DTensor):
        return _decode_on_shards(params, u, state, cfg)
    dt_ = u.dtype
    proj = linear(u, cast(params["in_proj"], dt_))                      # (B,1,*)
    local = dict(conv_w=cast(params["conv_w"], dt_), conv_b=cast(params["conv_b"], dt_),
                 **{k: params[k] for k in ("A_log", "D", "dt_bias", "norm")})
    y, conv, S = _decode_local(proj, state["conv"], state["ssm"], local, cfg)
    return linear(y, cast(params["out_proj"], dt_)), {"conv": conv, "ssm": S}


def _decode_local(proj, conv, ssm, params, cfg: ModelConfig, channels=slice(None),
                  heads=slice(None), groups=(None, None)):
    """The decode recurrence on plain tensors: ``proj`` the token's whole
    in_proj row (B,1,*), ``conv`` the conv state's ``channels`` (its conv_w
    and conv_b in ``params``), ``ssm`` the SSM state's ``heads``.  Where a
    group of ``groups`` (the conv channels' ranks, the heads' ranks) is
    given, the token's conv output and the heads' outputs are gathered over
    it.  -> (the normed y (B,1,d_inner), new conv state, new SSM state)."""
    dt_ = proj.dtype
    b = proj.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z, xbc, dtv = _split_proj(proj, cfg)
    hist = torch.cat([conv, xbc[..., channels]], dim=1)                 # (B,W,C')
    conv_out = torch.einsum("bwc,wc->bc", hist, params["conv_w"])
    conv_out = conv_out + params["conv_b"]
    act = F.silu(conv_out)
    if groups[0] is not None:
        act = sharding.all_gather_dim(act, -1, groups[0])
    xbc1 = act[:, None, :]                                              # (B,1,C)
    xh = xbc1[..., :di].reshape(b, h, p)[:, heads]
    Bm = xbc1[..., di:di + n].reshape(b, n)
    Cm = xbc1[..., di + n:].reshape(b, n)
    dt_act = softplus(dtv[:, 0].float() + params["dt_bias"])[:, heads]  # (B,H')
    a = torch.exp(-torch.exp(params["A_log"][heads]) * dt_act)          # (B,H')
    xw = xh.float() * dt_act[..., None]
    S = ssm * a[..., None, None] + torch.einsum("bn,bhp->bhnp", Bm.float(), xw)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), S)
    y = y + params["D"][heads][None, :, None] * xh.float()
    if groups[1] is not None:
        y = sharding.all_gather_dim(y, 1, groups[1])
    y = y.reshape(b, 1, di).to(dt_)
    y = y * F.silu(z)
    return rmsnorm(params["norm"], y), hist[:, 1:, :], S


def _decode_on_shards(params, u, state: Dict, cfg: ModelConfig):
    """`mamba2_decode` of DTensor states: the conv state split over its
    channels and the SSM state over its heads (`sharding.cache_pspecs`),
    each rank advancing its own slab.  The projection is taken whole (on the
    states' batch rows); each rank convolves its channels, the token's conv
    output is gathered over the channels' ranks (one (B, C) row), each rank
    updates and reads its heads' states, and the heads' outputs are gathered
    before the gate, the norm and out_proj (`_decode_local`).  The states
    never move."""
    from torch.distributed.tensor import Replicate, Shard

    conv, ssm_st = state["conv"], state["ssm"]
    mesh = conv.device_mesh
    dt_ = u.dtype
    di = cfg.d_inner
    rows = [Shard(0) if pl.is_shard(0) else Replicate() for pl in conv.placements]
    proj = linear(u, cast(params["in_proj"], dt_)).redistribute(mesh, rows).to_local()
    (c0, c1), (h0, h1) = sharding.slab(conv, 2), sharding.slab(ssm_st, 1)
    ch = tuple(mesh.mesh_dim_names[i] for i, pl in enumerate(conv.placements) if pl.is_shard(2))
    w = sharding.redistribute(cast(params["conv_w"], dt_), (None, sharding._entry(ch)))
    bias = sharding.redistribute(cast(params["conv_b"], dt_), (sharding._entry(ch),))
    whole = [Replicate()] * mesh.ndim
    a_log, d_skip, dt_bias, norm = (t.redistribute(mesh, whole).to_local() for t in (
        params["A_log"], params["D"], params["dt_bias"], params["norm"]["scale"]))
    local = dict(conv_w=w.to_local(), conv_b=bias.to_local(), A_log=a_log, D=d_skip,
                 dt_bias=dt_bias, norm={"scale": norm})
    y, hist, S = _decode_local(proj, conv.to_local(), ssm_st.to_local(), local, cfg,
                               slice(c0, c1), slice(h0, h1),
                               (sharding.split_group(conv, 2), sharding.split_group(ssm_st, 1)))
    y = DTensor.from_local(y, mesh, rows, run_check=False, shape=(u.shape[0], 1, di),
                           stride=(di, di, 1))
    return (linear(y, cast(params["out_proj"], dt_)),
            {"conv": sharding.like_local(hist, conv), "ssm": sharding.like_local(S, ssm_st)})
