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

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.models.layers import Init, cast, rmsnorm, rmsnorm_init, torch_dtype


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


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, width W. xbc: (B,S,C); w: (W,C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return out + b


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
    proj = u @ cast(params["in_proj"], dt_)
    z, xbc_raw, dtv = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc_raw, cast(params["conv_w"], dt_), cast(params["conv_b"], dt_))
    xbc = F.silu(xbc)
    xh = xbc[..., :di].reshape(b, s, h, p)
    Bm = xbc[..., di:di + n]
    Cm = xbc[..., di + n:]
    dt_act = softplus(dtv.float() + params["dt_bias"])                 # (B,S,H)
    log_a = -torch.exp(params["A_log"]) * dt_act                        # (B,S,H), <= 0
    x_in = xh * dt_act[..., None].to(dt_)
    if use_kernel:
        y, s_final = ssd_ops.ssd_log(log_a, Bm, Cm, x_in, cfg.ssm_chunk, cfg.ssd_intra_dtype)
    else:
        y, s_final = _ssd_chunked(log_a, Bm, Cm, x_in, cfg.ssm_chunk, return_state=True,
                                  intra_dtype=cfg.ssd_intra_dtype)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y)
    out = y @ cast(params["out_proj"], dt_)
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

    Returns the output and new {"conv", "ssm"} tensors (the caller stores them).
    """
    dt_ = u.dtype
    b = u.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    proj = u @ cast(params["in_proj"], dt_)                             # (B,1,*)
    z, xbc, dtv = _split_proj(proj, cfg)
    hist = torch.cat([state["conv"], xbc], dim=1)                       # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", hist, cast(params["conv_w"], dt_))
    conv_out = conv_out + cast(params["conv_b"], dt_)
    new_conv = hist[:, 1:, :]
    xbc1 = F.silu(conv_out)[:, None, :]                                 # (B,1,C)
    xh = xbc1[..., :di].reshape(b, h, p)
    Bm = xbc1[..., di:di + n].reshape(b, n)
    Cm = xbc1[..., di + n:].reshape(b, n)
    dt_act = softplus(dtv[:, 0].float() + params["dt_bias"])             # (B,H)
    a = torch.exp(-torch.exp(params["A_log"]) * dt_act)                 # (B,H)
    xw = xh.float() * dt_act[..., None]
    S = state["ssm"] * a[..., None, None] + torch.einsum("bn,bhp->bhnp", Bm.float(), xw)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), S)
    y = y + params["D"][None, :, None] * xh.float()
    y = y.reshape(b, 1, di).to(dt_)
    y = y * F.silu(z)
    y = rmsnorm(params["norm"], y)
    return y @ cast(params["out_proj"], dt_), {"conv": new_conv, "ssm": S}
