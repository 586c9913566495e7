"""Plain torch versions of attention: the JAX package's oracle and the kernel's.

* `mha_ref` ports ``repro.kernels.attention.ref.mha_ref``: kv heads repeated,
  logits from q's dtype einsum then float32, a softmax normalised before P is
  rounded to v's dtype.  Its default scale is ``1/sqrt(d)`` rounded to q's
  dtype, as the reference's is.
* `flash_ref` is the function ``csrc/flash.cu`` computes (and the Pallas
  ``flash_attention_single`` before it), densely: float32 logits, the mask
  at -1e30, P = exp(logits - rowmax) rounded to v's dtype *before*
  normalising, P.V accumulated in float32, then divided by the row sum
  (1 where it is 0).  Kv head = q head // group, gathered by index.  With
  ``return_lse`` it also returns each row's log-sum-exp of the scaled,
  masked logits, (B, Hq, S): the forward kernels' second output in training.
* `flash_bwd_ref` is the function of the backward kernels
  (``flash_bwd_preprocess_kernel``, ``flash_bwd_dkdv_kernel``,
  ``flash_bwd_dq_kernel``), densely, the FlashAttention-2 way: P recomputed
  from the LSE, D = rowsum(dO * O), dS = P * (dP - D); dK and dV summed over
  each kv head's q-head group.  It rounds where the kernels round: P to v's
  dtype before P^T dO, dS to q's dtype before dS K and dS^T Q (the identity
  in float32 and float64).
* `dkdv_reduce_ref` is ``flash_bwd_dkdv_reduce_kernel``'s function: the
  split grid's per-q-head dK and dV partials added over each group in
  q-head order.

Both accumulate in float32 (float64 operands stay float64, so that
``torch.autograd.gradcheck`` can hold the autograd Function built on them).
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


def _acc(dtype) -> torch.dtype:
    """The accumulation dtype: float32, or float64 for float64 operands."""
    return torch.promote_types(dtype, torch.float32)


def flash_ref(q, k, v, causal=True, window=None, scale=None, return_lse=False):
    """The flash kernel's function, densely.  q: (B, Hq, S, D); k/v: (B, Hkv, S, D).

    -> o (B, Hq, S, D) in q's dtype; with ``return_lse`` (o, lse (B, Hq, S)
    float32).
    """
    hq, s, d = q.shape[1], q.shape[2], q.shape[3]
    acc = _acc(q.dtype)
    kv_idx = torch.arange(hq, device=q.device) // (hq // k.shape[1])
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    kf = k[:, kv_idx].to(acc)
    vf = v[:, kv_idx]
    logits = (q.to(acc) @ kf.transpose(-1, -2)) * scale
    logits = torch.where(_mask(s, causal, window, q.device), logits, NEG_INF)
    mx = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - mx)
    l = p.sum(-1, keepdim=True)
    out = p.to(v.dtype).to(acc) @ vf.to(acc)
    o = (out / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return o
    return o, (mx + torch.log(l))[..., 0]


def flash_bwd_ref(q, k, v, o, lse, do, causal=True, window=None, scale=None):
    """The backward kernels' function, densely -> (dq, dk, dv), each in its
    operand's dtype.

    q, o, do: (B, Hq, S, D); k, v: (B, Hkv, S, D); lse: (B, Hq, S), the
    forward's per-row log-sum-exp of the scaled logits.  P = exp(logits *
    scale - lse) where the mask keeps the pair (0 elsewhere), D = rowsum(dO *
    O), dP = dO V^T, dS = P (dP - D); dQ = scale dS K, dK = scale dS^T Q and
    dV = P^T dO, the last two summed over the q heads that share a kv head.
    As the kernels do (and FlashAttention-2 and SDPA), P is rounded to v's
    dtype before P^T dO and dS to q's dtype before dS K and dS^T Q, each
    product accumulated in float32: in bf16 that is where the tensor cores
    take their operands; in float32 (and float64) it changes nothing.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    acc = _acc(q.dtype)
    kv_idx = torch.arange(hq, device=q.device) // group
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    kf, vf = k[:, kv_idx].to(acc), v[:, kv_idx].to(acc)
    logits = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(_mask(s, causal, window, q.device),
                    torch.exp(logits - lse.to(acc)[..., None]), torch.zeros((), dtype=acc,
                                                                            device=q.device))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = (p * (dof @ vf.transpose(-1, -2) - delta)).to(q.dtype).to(acc)
    p = p.to(v.dtype).to(acc)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).reshape(b, hkv, group, s, d).sum(2) * scale
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, group, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dkdv_reduce_ref(part, hkv, scale, dtype):
    """part: (2, B, Hq, S, D) float32, the split grid's unscaled per-q-head
    dK (part[0]) and dV (part[1]) sums -> (dk, dv) (B, Hkv, S, D) in
    ``dtype``: each group added in q-head order from its first head, dK
    then scaled."""
    _, b, hq, s, d = part.shape
    group = hq // hkv
    pk, pv = (x.reshape(b, hkv, group, s, d) for x in part)
    dk, dv = pk[:, :, 0], pv[:, :, 0]
    for i in range(1, group):
        dk, dv = dk + pk[:, :, i], dv + pv[:, :, i]
    return (dk * scale).to(dtype), dv.to(dtype)
