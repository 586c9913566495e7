"""Wrapper of the hand-written Hopper flash-attention kernels (``csrc/flash.cu``).

`flash_attention` checks its operands, then:

* CPU tensors go to the kernels' plain torch version, `ref.flash_ref`;
* CUDA tensors launch, on ``torch.cuda.current_stream()`` with the output
  from ``torch.empty``, the kernel of their dtype (`ENTRY_POINTS`):
  bfloat16 ``flash_fwd_bf16_kernel`` on the tensor cores, float32
  ``flash_fwd_kernel`` on the CUDA cores; and raise if the launch returns an
  error.  There is no fallback from one kernel to the other or to the plain
  version.

Only a successful launch adds one to ``flash_attention.launches``.
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


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.

    Forward attention with an online softmax, the function of the JAX
    package's ``flash_attention`` (kv head = q head // group, causal and
    sliding-window masks, scale ``1/sqrt(D)`` by default), for any S.  The
    operands may be strided views whose last axis is contiguous; the output
    takes q's memory layout, so a (B, S, H, D) activation seen as
    (B, H, S, D) comes back the same way.
    """
    _check(q, k, v, window)
    b, hq, s, d = q.shape
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    if q.device.type == "cpu":
        return ref.flash_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash kernel takes {DTYPES}, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head dims {HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must have a contiguous last axis")
    o = torch.empty_like(q)   # q's layout when q is dense
    if o.stride(3) != 1:      # a non-dense q may suggest another memory format
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, o, causal, window, scale, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def _launch(q, k, v, o, causal, window, scale, device: int, stream: int) -> None:
    """Call q's dtype's entry point of ``csrc/flash.cu`` on checked operands;
    raise if it returns an error."""
    entry = ENTRY_POINTS[q.dtype]
    b, hq, s, d = q.shape
    lib = build.library("flash")
    strides = [st for t in (q, k, v, o) for st in (t.stride(0), t.stride(1), t.stride(2))]
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *strides,
        b, hq, k.shape[1], s, d, int(causal), 0 if window is None else int(window), scale,
        device, stream,
    )
    build.check(lib, err, f"{entry} launch")
