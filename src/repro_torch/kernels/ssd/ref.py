"""Plain torch versions of the Mamba-2 SSD recurrence.

State-space recurrence with scalar-identity A (Mamba-2 / SSD, arXiv:2405.21060):

    S_t = a_t * S_{t-1} + B_t x_t^T        S in R^{N x P}
    y_t = C_t^T S_t

* `ssd_scan_ref` / `ssd_batched_ref` port ``repro.kernels.ssd.ref``: the
  step-by-step scan, a_t in (0, 1].
* `ssd_chunked_ref` is the function ``csrc/ssd.cu`` computes: the JAX
  model's log-space chunked form (``repro.models.ssm._ssd_chunked``) with the
  final state, the inter-chunk carry as a loop over chunks.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(a, B, C, x):
    """a: (T,), B: (T,N), C: (T,N), x: (T,P) -> y: (T,P) float32. Step by step."""
    S = torch.zeros((B.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(a.shape[0]):
        S = a[t] * S + torch.outer(B[t], x[t])
        ys.append(C[t] @ S)
    return torch.stack(ys)


def ssd_batched_ref(a, B, C, x):
    """a: (Bt,T,H), B/C: (Bt,T,N), x: (Bt,T,H,P) -> (Bt,T,H,P) float32.

    B and C are shared across heads (Mamba-2 convention).
    """
    bt, t, h = a.shape
    n = B.shape[-1]
    S = torch.zeros((bt, h, n, x.shape[-1]), dtype=torch.float32, device=x.device)
    Bf, Cf, xf = B.float(), C.float(), x.float()
    ys = []
    for i in range(t):
        S = a[:, i, :, None, None] * S + Bf[:, i, None, :, None] * xf[:, i, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, i], S))
    return torch.stack(ys, dim=1)


def ssd_chunked_ref(log_a, Bm, Cm, x, chunk: int, intra_dtype="float32"):
    """The chunked SSD in log space -> (y (B,S,H,P) float32, state (B,H,N,P) float32).

    log_a: (B,S,H) log-decay (<= 0); Bm/Cm: (B,S,N); x: (B,S,H,P).  A ragged
    sequence is padded with identity steps (log_a = 0, B = C = x = 0) that
    leave the state unchanged and are sliced off the output.  The intra-chunk
    quadratic work runs in ``intra_dtype``; the decay sums stay float32.
    """
    b, s, h = log_a.shape
    n = Bm.shape[-1]
    p = x.shape[-1]
    l = min(chunk, s)
    s_orig = s
    if s % l:
        pad = l - s % l
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // l
    Br = Bm.reshape(b, nc, l, n)
    Cr = Cm.reshape(b, nc, l, n)
    xr = x.reshape(b, nc, l, h, p)

    cum = torch.cumsum(log_a.reshape(b, nc, l, h).float(), dim=2)   # inclusive
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    idx = torch.arange(l, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    # Mask BEFORE exp: for j > i the exponent is positive and can overflow.
    diff = torch.where(causal, li - lj, torch.zeros((), device=x.device))
    idt = getattr(torch, intra_dtype)
    m = torch.where(causal, torch.exp(diff), torch.zeros((), device=x.device)).to(idt)
    cb = torch.einsum("bcin,bcjn->bcij", Cr.to(idt), Br.to(idt))
    g = cb[..., None] * m                                           # (B,nc,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", g, xr.to(idt)).float()

    w_last = torch.exp(cum[:, :, -1:, :] - cum)                     # (B,nc,L,H)
    t_sum = torch.einsum("bcjn,bcjhp->bchnp", Br.float(), xr.float() * w_last[..., None])
    decay = torch.exp(cum[:, :, -1, :])                             # (B,nc,H)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * decay[:, c, :, None, None] + t_sum[:, c]
    s_in = torch.stack(s_in, dim=1)                                 # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cr.float(), s_in) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y, state
