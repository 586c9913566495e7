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


def _wide(log_a):
    """The plain chunked forms' working dtype: float32, float64 for float64
    operands (the gradient checks)."""
    return torch.float64 if log_a.dtype == torch.float64 else torch.float32


def ssd_chunked_ref(log_a, Bm, Cm, x, chunk: int, intra_dtype="float32"):
    """The chunked SSD in log space -> (y (B,S,H,P) float32, state (B,H,N,P) float32).

    log_a: (B,S,H) log-decay (<= 0); Bm/Cm: (B,S,N); x: (B,S,H,P).  A ragged
    sequence is padded with identity steps (log_a = 0, B = C = x = 0) that
    leave the state unchanged and are sliced off the output.  The intra-chunk
    quadratic work runs in ``intra_dtype``; the decay sums stay float32
    (float64 for float64 operands: the gradient checks).
    """
    wide = _wide(log_a)
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

    cum = torch.cumsum(log_a.reshape(b, nc, l, h).to(wide), dim=2)   # inclusive
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    idx = torch.arange(l, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    # Mask BEFORE exp: for j > i the exponent is positive and can overflow.
    diff = torch.where(causal, li - lj, torch.zeros((), device=x.device))
    idt = wide if intra_dtype == "float32" else getattr(torch, intra_dtype)
    m = torch.where(causal, torch.exp(diff), torch.zeros((), device=x.device)).to(idt)
    cb = torch.einsum("bcin,bcjn->bcij", Cr.to(idt), Br.to(idt))
    g = cb[..., None] * m                                           # (B,nc,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", g, xr.to(idt)).to(wide)

    w_last = torch.exp(cum[:, :, -1:, :] - cum)                     # (B,nc,L,H)
    t_sum = torch.einsum("bcjn,bcjhp->bchnp", Br.to(wide), xr.to(wide) * w_last[..., None])
    decay = torch.exp(cum[:, :, -1, :])                             # (B,nc,H)
    state = torch.zeros((b, h, n, p), dtype=wide, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * decay[:, c, :, None, None] + t_sum[:, c]
    s_in = torch.stack(s_in, dim=1)                                 # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cr.to(wide), s_in) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y, state


#: The kernels' sub-chunk (``csrc/ssd.cu`` kL, ``ops.MAX_TILE``): the backward
#: below works in chunks of at most this many steps, as the kernels do.
TILE = 64


def ssd_chunked_bwd_ref(log_a, Bm, Cm, x, dy, dstate, chunk: int, states: bool = False):
    """The gradient of `ssd_chunked_ref` (float32 intra-chunk work) in the
    backward kernels' decomposition -> (d log_a float32, dB, dC, dx, each in
    its operand's dtype; with ``states``, also dS', (B, n_chunks, H, N, P):
    what the state pass kernel writes).

    ``dy`` (B,S,H,P) is y's gradient, ``dstate`` (B,H,N,P) the final
    state's (None: zeros).  The sequence runs in chunks of min(chunk, TILE)
    steps (the same function: the SSD identity), a ragged end padded with
    identity steps that get no gradient.  Per chunk, with cum the inclusive
    sum of log_a, S the state entering it and dS' the gradient of the state
    leaving it (a reverse pass: dS' of the last chunk is ``dstate``, and
    dS = exp(cum_L) dS' + sum_i exp(cum_i) C_i dy_i^T), G = C B^T,
    D_ij = dy_i . x_j, M_ij = exp(cum_i - cum_j) for j <= i (masked before
    the exp), A = M o G, W = M o D, w_j = exp(cum_L - cum_j):

        dx   = A^T dy + w o (B dS')
        dC   = sum_h W B + exp(cum) o (dy S^T)
        dB   = sum_h W^T C + w o (x dS'^T)
        dcum = rowsum(A o D) - colsum(A o D) + C . dC_inter - x . dx_inter,
               plus exp(cum_L) <S, dS'> + sum_j x_j . dx_inter_j at the last step

    and d log_a is the reverse cumulative sum of dcum within the chunk.  The
    chunk states are recomputed with `ssd_chunked_ref`'s loop.
    """
    b, s, h = log_a.shape
    n, p = Bm.shape[-1], x.shape[-1]
    wide = _wide(log_a)
    l = min(chunk, TILE, s)
    pad = -s % l
    nc = (s + pad) // l

    def rows(t):   # the working dtype, padded with identity steps, in chunks
        t = torch.nn.functional.pad(t.to(wide), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, l, *t.shape[2:])

    Br, Cr, xr, dyr = rows(Bm), rows(Cm), rows(x), rows(dy)
    cum = torch.cumsum(rows(log_a), dim=2)                          # (B,nc,L,H)
    idx = torch.arange(l, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]  # [i][j]
    zero = torch.zeros((), device=x.device)
    diff = torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], zero)
    m = torch.where(causal, torch.exp(diff), zero)                  # (B,nc,L,L,H)
    w_last = torch.exp(cum[:, :, -1:, :] - cum)                     # (B,nc,L,H)
    decay = torch.exp(cum[:, :, -1, :])                             # (B,nc,H)
    e_cum = torch.exp(cum)

    # The states entering each chunk (forward) and the gradients of those
    # leaving it (the reverse pass).
    t_sum = torch.einsum("bcjn,bcjhp->bchnp", Br, xr * w_last[..., None])
    q_sum = torch.einsum("bcin,bcihp->bchnp", Cr, dyr * e_cum[..., None])
    state = torch.zeros((b, h, n, p), dtype=wide, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * decay[:, c, :, None, None] + t_sum[:, c]
    s_in = torch.stack(s_in, dim=1)                                 # (B,nc,H,N,P)
    g = state.new_zeros(state.shape) if dstate is None else dstate.to(wide)
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = g
        g = g * decay[:, c, :, None, None] + q_sum[:, c]
    ds_out = torch.stack(ds_out, dim=1)                             # (B,nc,H,N,P)

    gmat = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    dmat = torch.einsum("bcihp,bcjhp->bcijh", dyr, xr)
    a = m * gmat[..., None]
    wm = m * dmat
    dx_inter = torch.einsum("bcjn,bchnp->bcjhp", Br, ds_out) * w_last[..., None]
    dx = torch.einsum("bcijh,bcihp->bcjhp", a, dyr) + dx_inter
    dc_inter = torch.einsum("bcihp,bchnp->bcihn", dyr, s_in) * e_cum[..., None]
    dC = torch.einsum("bcijh,bcjn->bcin", wm, Br) + dc_inter.sum(3)
    db_inter = torch.einsum("bcjhp,bchnp->bcjhn", xr, ds_out) * w_last[..., None]
    dB = torch.einsum("bcijh,bcin->bcjn", wm, Cr) + db_inter.sum(3)
    v = a * dmat
    z = (xr * dx_inter).sum(-1)                                     # (B,nc,L,H)
    dcum = v.sum(3) - v.sum(2) + (Cr[:, :, :, None, :] * dc_inter).sum(-1) - z
    last = decay * torch.einsum("bchnp,bchnp->bch", s_in, ds_out) + z.sum(2)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], dim=2)
    dla = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))

    def out(t, like):
        return t.reshape(b, nc * l, *t.shape[3:])[:, :s].to(like.dtype)

    grads = out(dla, log_a), out(dB, Bm), out(dC, Cm), out(dx, x)
    return grads + (ds_out,) if states else grads
