"""Plain torch versions of attention: the JAX package's oracle and the kernel's.

* `mha_ref` ports ``repro.kernels.attention.ref.mha_ref``: kv heads repeated,
  logits from q's dtype einsum then float32, a softmax normalised before P is
  rounded to v's dtype.  Its default scale is ``1/sqrt(d)`` rounded to q's
  dtype, as the reference's is.
* `flash_ref` is the function ``csrc/flash.cu`` computes (and the Pallas
  ``flash_attention_single`` before it), densely: float32 logits, the mask
  at -1e30, P = exp(logits - rowmax) rounded to v's dtype *before*
  normalising, P.V accumulated in float32, then divided by the row sum
  (1 where it is 0).  Kv head = q head // group, gathered by index.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(s: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def mha_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with Hq % Hkv == 0 -> (B, Hq, S, D)."""
    hq, s, d = q.shape[1], q.shape[2], q.shape[3]
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    logits = torch.where(_mask(s, causal, window, q.device), logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_ref(q, k, v, causal=True, window=None, scale=None):
    """The flash kernel's function, densely.  q: (B, Hq, S, D); k/v: (B, Hkv, S, D)."""
    hq, s, d = q.shape[1], q.shape[2], q.shape[3]
    kv_idx = torch.arange(hq, device=q.device) // (hq // k.shape[1])
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    kf = k[:, kv_idx].float()
    vf = v[:, kv_idx]
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    logits = torch.where(_mask(s, causal, window, q.device), logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    acc = p.to(v.dtype).float() @ vf.float()
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
