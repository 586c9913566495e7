"""Wrapper of the hand-written Hopper SSD scan kernels (``csrc/ssd.cu``).

`ssd_log` checks its operands, then:

* CPU tensors go to the kernels' plain torch version, `ref.ssd_chunked_ref`;
* CUDA tensors launch ``ssd_chunk_state_kernel``, ``ssd_state_pass_kernel``
  and ``ssd_chunk_scan_kernel`` (one C call, `KERNELS_PER_CALL` launches) on
  ``torch.cuda.current_stream()``, with outputs and scratch from
  ``torch.empty``, and raise if a launch returns an error.  There is no
  fallback from the kernels to the plain version.

Only a successful call adds one to ``ssd_log.launches``.  `ssd` is the
JAX package's ``a``-form interface over the same kernels.

Under grad (grad enabled and an operand that requires it) `ssd_log` goes
through `SSDScan`, an autograd Function: on the CPU its backward runs
autograd through `ref.ssd_chunked_ref`; on a card it raises
`NotImplementedError` before anything is launched (the SSD backward
kernels are not written yet) and never falls back to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref

#: State sizes N the kernel is built for, its head dim P and its longest
#: sub-chunk (longer chunks run as 64-step sub-chunks: the same function).
STATE_SIZES = (64, 128)
HEAD_DIM = 64
MAX_TILE = 64
DTYPES = (torch.float32, torch.bfloat16)
#: Kernel launches one `ssd_log` call makes on a card.
KERNELS_PER_CALL = 3
#: Blocks of the chunk kernels one SM holds at N 64 (csrc/ssd.cu's launch
#: bounds): the launch aims for this many on each of the card's SMs.
BLOCKS_PER_SM = 2
#: Most heads one block of the chunk kernels may own (csrc/ssd.cu kMaxGroup).
MAX_GROUP = 16


def heads_per_block(batch: int, n_chunks: int, nheads: int, sm_count: int) -> int:
    """Heads one block of the chunk kernels owns: `MAX_GROUP` (C Bᵀ computed
    once for 16 heads), halved while the launch would have fewer than
    `BLOCKS_PER_SM` blocks for each of the card's `sm_count` SMs (on an
    H100's 132, a 1 x 1000 prefill: 16 chunks, 2 heads)."""
    g = MAX_GROUP
    while g > 1 and batch * n_chunks * -(-nheads // g) < BLOCKS_PER_SM * sm_count:
        g //= 2
    return min(g, nheads)


def _check(log_a, Bm, Cm, x, chunk):
    for name, t in (("log_a", log_a), ("B", Bm), ("C", Cm), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if log_a.dim() != 3 or Bm.dim() != 3 or x.dim() != 4:
        raise ValueError(f"need log_a (B,T,H), B/C (B,T,N), x (B,T,H,P); got "
                         f"{tuple(log_a.shape)}, {tuple(Bm.shape)}, {tuple(x.shape)}")
    b, t, h = log_a.shape
    if Cm.shape != Bm.shape or Bm.shape[:2] != (b, t) or x.shape[:3] != (b, t, h):
        raise ValueError(f"shapes disagree: log_a {tuple(log_a.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}, x {tuple(x.shape)}")
    if log_a.dtype != torch.float32:
        raise ValueError(f"log_a must be float32, got {log_a.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"B, C and x must share a dtype, got {Bm.dtype}, {Cm.dtype}, {x.dtype}")
    if min(b, t, h) < 1 or chunk < 1:
        raise ValueError(f"need a non-empty batch, sequence and heads and chunk >= 1, got "
                         f"log_a {tuple(log_a.shape)}, chunk {chunk}")


def ssd_log(log_a, Bm, Cm, x, chunk: int = 64, intra_dtype: str = "float32"):
    """The chunked SSD scan -> (y (B,T,H,P) float32, final state (B,H,N,P) float32).

    log_a: (B,T,H) float32 log-decay (<= 0); B/C: (B,T,N), shared across
    heads; x: (B,T,H,P).  Any T: a ragged last chunk is padded with identity
    steps.  The operands may be strided views whose last axis is contiguous
    (the model's slices of its conv output).  On a card a block of the chunk
    kernels owns `heads_per_block` heads (the last block fewer when that
    does not divide H), and the call allocates two scratch tensors: the
    chunk states, (B, n_chunks, H, N, P) float32, and the decays,
    (B, n_chunks, H, 64).
    """
    _check(log_a, Bm, Cm, x, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (log_a, Bm, Cm, x)):
        if x.device.type != "cpu":
            raise NotImplementedError(
                "ssd_log has no backward kernel on a card yet (the SSD backward slice, ROADMAP "
                "queue 1 item 5a): ssm and hybrid models train on the CPU only")
        return SSDScan.apply(log_a, Bm, Cm, x, chunk, intra_dtype)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(log_a, Bm, Cm, x, chunk, intra_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd kernel for device {x.device}")
    b, t, h = log_a.shape
    n, p = Bm.shape[2], x.shape[3]
    if intra_dtype != "float32":
        raise ValueError(f"the ssd kernel computes in float32, got intra_dtype {intra_dtype}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd kernel takes {DTYPES}, got {x.dtype}")
    if n not in STATE_SIZES or p != HEAD_DIM:
        raise ValueError(f"ssd kernel is built for N in {STATE_SIZES} and P = {HEAD_DIM}, "
                         f"got N = {n}, P = {p}")
    if log_a.stride(2) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 or x.stride(3) != 1:
        raise ValueError("log_a, B, C and x must have a contiguous last axis")
    tile = min(chunk, MAX_TILE)
    n_chunks = -(-t // tile)
    group = heads_per_block(b, n_chunks, h,
                            torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=x.device)
    dstate = torch.empty((b, n_chunks, h, n, p), dtype=torch.float32, device=x.device)
    cums = torch.empty((b, n_chunks, h, MAX_TILE), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    _launch(log_a, Bm, Cm, x, y, dstate, cums, state, tile, group)
    ssd_log.launches += 1
    return y, state


ssd_log.launches = 0


class SSDScan(torch.autograd.Function):
    """`ssd_log` with its gradient, on the CPU: the forward is the plain
    version; the backward recomputes it under autograd and differentiates."""

    @staticmethod
    def forward(ctx, log_a, Bm, Cm, x, chunk, intra_dtype):
        ctx.save_for_backward(log_a, Bm, Cm, x)
        ctx.args = (chunk, intra_dtype)
        return ref.ssd_chunked_ref(log_a, Bm, Cm, x, chunk, intra_dtype)

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ref.ssd_chunked_ref(*inputs, *ctx.args)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad((y, state), wrt, (dy, dstate), allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def _launch(log_a, Bm, Cm, x, y, dstate, cums, state, tile: int, group: int) -> None:
    """Call ``csrc/ssd.cu``'s entry point on checked operands and outputs;
    raise if it returns an error."""
    b, t, h = log_a.shape
    lib = build.library("ssd")
    err = lib.ssd_scan_fwd(
        log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(), y.data_ptr(),
        dstate.data_ptr(), cums.data_ptr(), state.data_ptr(), log_a.stride(0), log_a.stride(1),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), x.stride(0), x.stride(1),
        x.stride(2), b, h, t, Bm.shape[2], tile, group, int(x.dtype == torch.bfloat16),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "ssd_scan launch")


def ssd(a, B, C, x, chunk: int = 64):
    """a: (Bt,T,H) decay in (0, 1], B/C: (Bt,T,N), x: (Bt,T,H,P) -> y in x's dtype.

    The JAX package's ``repro.kernels.ssd.ops.ssd``, through `ssd_log` on
    ``log(a)``.
    """
    y, _ = ssd_log(torch.log(a.float()), B, C, x, chunk)
    return y.to(x.dtype)
