"""Wrappers of the hand-written Hopper flash-attention kernels (``csrc/flash.cu``).

`flash_attention` checks its operands, then:

* CPU tensors go to the kernels' plain torch versions, `ref.flash_ref` and,
  for the gradient, `ref.flash_bwd_ref`;
* CUDA tensors launch, on ``torch.cuda.current_stream()`` with the output
  from ``torch.empty``, the kernel of their dtype (`ENTRY_POINTS`):
  bfloat16 ``flash_fwd_bf16_kernel`` on the tensor cores, float32
  ``flash_fwd_kernel`` on the CUDA cores; and raise if the launch returns an
  error.  There is no fallback from one kernel to the other or to the plain
  version.

Under grad (grad enabled and an operand that requires it) the call goes
through `FlashAttention`, an autograd Function: its forward launches the
same kernel with the per-row log-sum-exp written too and saves q, k, v, o
and the LSE; its backward is `flash_attention_bwd`, which launches
``flash_bwd_preprocess_kernel``, ``flash_bwd_dkdv_kernel`` and
``flash_bwd_dq_kernel`` in that order on the current stream (plain
`ref.flash_bwd_ref` on the CPU); on the split grid (`bwd_split`: a
small batch x kv heads with a group larger than 1) a fourth,
``flash_bwd_dkdv_reduce_kernel``, runs after dkdv and adds its blocks'
per-q-head partials.  Under ``torch.inference_mode`` (serving) the forward launches
without the LSE, as before.

Only a successful launch adds one to ``flash_attention.launches`` (forward)
or to ``flash_attention_bwd.launches`` and its kernel's entry of
``flash_attention_bwd.kernel_launches`` (backward: three or four a call).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import ref

#: Head dims the kernel is built for (the repo's configs use 64, 128, 256).
HEAD_DIMS = (64, 128, 256)
#: The C entry point of each dtype's kernel.
ENTRY_POINTS = {torch.float32: "flash_attention_fwd_f32",
                torch.bfloat16: "flash_attention_fwd_bf16"}
DTYPES = tuple(ENTRY_POINTS)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, D), got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"q, k, v must share dtype and device, got {name} "
                             f"{t.dtype} on {t.device}")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"kv heads {hkv} must divide q heads {hq}")
    if min(b, s) < 1:
        raise ValueError(f"need a non-empty batch and sequence, got q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(d))


def _check_card(q, k, v) -> None:
    """What the kernels take on a card; raise on anything else."""
    d = q.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash kernel takes {DTYPES}, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims {HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must have a contiguous last axis")


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor in t's memory layout where that keeps D contiguous."""
    out = torch.empty_like(t)   # t's layout when t is dense
    if out.stride(3) != 1:      # a non-dense t may suggest another memory format
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _forward(q, k, v, causal, window, scale, with_lse):
    """o, or (o, lse) with ``with_lse``: the plain version on the CPU, the
    kernel on a card."""
    if q.device.type == "cpu":
        return ref.flash_ref(q, k, v, causal=causal, window=window, scale=scale,
                             return_lse=with_lse)
    _check_card(q, k, v)
    b, hq, s, _ = q.shape
    o = _like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if with_lse else None
    _launch(q, k, v, o, causal, window, scale, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream, lse=lse)
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.

    Forward attention with an online softmax, the function of the JAX
    package's ``flash_attention`` (kv head = q head // group, causal and
    sliding-window masks, scale ``1/sqrt(D)`` by default), for any S.  The
    operands may be strided views whose last axis is contiguous; the output
    takes q's memory layout, so a (B, S, H, D) activation seen as
    (B, H, S, D) comes back the same way.  Differentiable under grad
    (`FlashAttention`).
    """
    _check(q, k, v, window)
    scale = _scale(q.shape[3], scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, with_lse=False)


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with its gradient: the forward kernel with the LSE,
    the backward kernels (their plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


#: The backward's kernels, in launch order, and their C entry points; the
#: reduction launches on the split grid only.
BWD_KERNELS = {"flash_bwd_preprocess_kernel": "flash_attention_bwd_preprocess",
               "flash_bwd_dkdv_kernel": "flash_attention_bwd_dkdv",
               "flash_bwd_dkdv_reduce_kernel": "flash_attention_bwd_dkdv_reduce",
               "flash_bwd_dq_kernel": "flash_attention_bwd_dq"}
#: Streaming multiprocessors of an H100 SXM: the split grid's yardstick
#: (one dkdv block an SM at every D and dtype).
SM_COUNT = 132


def bwd_key_tile(d: int, dtype: torch.dtype) -> int:
    """Keys a ``flash_bwd_dkdv_kernel`` block owns at head dim ``d``, as the
    built library says (``csrc/flash.cu``: ``flash_attention_bwd_key_tile``);
    a card only."""
    tile = build.library("flash").flash_attention_bwd_key_tile(d, int(dtype == torch.bfloat16))
    if tile <= 0:
        raise ValueError(f"no flash backward kernel for head dim {d}")
    return tile


def bwd_split(b: int, hq: int, hkv: int, s: int, key_tile: int) -> bool:
    """Whether the backward runs the split grid: one dkdv block per (batch,
    q head, key tile), partials summed by ``flash_bwd_dkdv_reduce_kernel``,
    where one block per (batch, kv head, key tile) of ``key_tile`` keys
    would be under one and a half waves of `SM_COUNT` blocks and the group
    is larger than 1 (where the split grid paid on an H100 at qwen2's 12:2
    D 128 S 4096: PERF.md).  A function of the shape alone, so that two
    runs give the same bits."""
    return hq > hkv and 2 * b * hkv * -(-s // key_tile) < 3 * SM_COUNT


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: Optional[int] = None, scale: Optional[float] = None):
    """-> (dq, dk, dv) of `flash_attention` at (q, k, v), given its output o,
    the forward's per-row LSE (B, Hq, S) float32 and the output's gradient
    ``do``; each gradient in its operand's dtype and, where that keeps D
    contiguous, its layout.  `ref.flash_bwd_ref` on the CPU; on a card the
    three backward kernels, no fallback.
    """
    _check(q, k, v, window)
    scale = _scale(q.shape[3], scale)
    if q.device.type == "cpu":
        return ref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
    (dq, dk, dv, _, _), calls = bwd_launches(q, k, v, o, lse, do, causal, window, scale)
    for kernel, call in calls.items():
        call()
        flash_attention_bwd.launches += 1
        flash_attention_bwd.kernel_launches[kernel] += 1
    return dq, dk, dv


def bwd_launches(q, k, v, o, lse, do, causal, window, scale, split: Optional[bool] = None):
    """Check the backward's operands on a card and allocate its outputs ->
    ((dq, dk, dv, delta, part), {kernel: a function that launches it and
    raises if the launch fails}), the kernels in `BWD_KERNELS` order (the
    reduction only on the split grid, where ``part`` is its (2, B, Hq, S,
    D) float32 scratch of dK and dV partials; else None).  ``split`` None
    takes the grid `bwd_split` picks; True or False forces one (to time
    the two against each other).  Nothing is launched or counted here."""
    _check_card(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    b, hq, s, d = q.shape
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous ({b}, {hq}, {s}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    do = do.to(q.dtype)
    if o.stride(3) != 1:
        o = o.contiguous()
    if do.stride(3) != 1:
        do = do.contiguous()
    dq, dk, dv = _like(q), _like(k), _like(v)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    hkv = k.shape[1]
    lib = build.library("flash")
    if split is None:
        split = bwd_split(b, hq, hkv, s, bwd_key_tile(d, q.dtype))
    part = torch.empty((2, b, hq, s, d), dtype=torch.float32, device=q.device) if split else None
    tail = (int(q.dtype == torch.bfloat16), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    mask = (int(causal), 0 if window is None else int(window), scale)

    def strides(*ts):
        return [st for t in ts for st in (t.stride(0), t.stride(1), t.stride(2))]

    def launcher(kernel, tensors, *rest):
        entry = BWD_KERNELS[kernel]

        def call():   # keeps its tensors (do's copy too) alive as long as it lives
            err = getattr(lib, entry)(*(None if t is None else t.data_ptr() for t in tensors),
                                      *rest)
            build.check(lib, err, f"{entry} launch")
        return call

    calls = {
        "flash_bwd_preprocess_kernel": launcher(
            "flash_bwd_preprocess_kernel", (o, do, delta), *strides(o, do), b, hq, s, d, *tail),
        "flash_bwd_dkdv_kernel": launcher(
            "flash_bwd_dkdv_kernel", (q, k, v, do, lse, delta, dk, dv, part),
            *strides(q, k, v, do, dk, dv), b, hq, hkv, s, d, *mask, *tail),
    }
    if part is not None:
        calls["flash_bwd_dkdv_reduce_kernel"] = launcher(
            "flash_bwd_dkdv_reduce_kernel", (part, dk, dv), *strides(dk, dv), b, hq, hkv, s, d,
            scale, *tail)
    calls["flash_bwd_dq_kernel"] = launcher(
        "flash_bwd_dq_kernel", (q, k, v, do, lse, delta, dq), *strides(q, k, v, do, dq), b, hq,
        hkv, s, d, *mask, *tail)
    return (dq, dk, dv, delta, part), calls


flash_attention_bwd.launches = 0
flash_attention_bwd.kernel_launches = dict.fromkeys(BWD_KERNELS, 0)


def _launch(q, k, v, o, causal, window, scale, device: int, stream: int, lse=None) -> None:
    """Call q's dtype's entry point of ``csrc/flash.cu`` on checked operands
    (``lse``: None, or a contiguous (B, Hq, S) float32 output); raise if it
    returns an error."""
    entry = ENTRY_POINTS[q.dtype]
    b, hq, s, d = q.shape
    lib = build.library("flash")
    strides = [st for t in (q, k, v, o) for st in (t.stride(0), t.stride(1), t.stride(2))]
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), *strides,
        b, hq, k.shape[1], s, d, int(causal), 0 if window is None else int(window), scale,
        device, stream,
    )
    build.check(lib, err, f"{entry} launch")
