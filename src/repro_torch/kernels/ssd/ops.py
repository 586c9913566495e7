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
through `SSDScan`, an autograd Function.  On a card its forward launches the
same three kernels and keeps their scratch for the backward: the states
entering each chunk, (B, n_chunks, H, N, P), and the decays, (B, n_chunks,
H, 64), both float32.  Its backward is `ssd_log_bwd`, which launches
``ssd_bwd_state_pass_kernel`` (the chunk sums fused into the reverse state
pass: it writes the dS' scratch), ``ssd_bwd_chunk_scan_kernel`` and
``ssd_bwd_reduce_kernel`` in that order (`BWD_KERNELS`), with no fallback;
the first two run their products on the tensor cores at float32 accuracy
(3xTF32, ``csrc/ssd.cu``).  On the CPU the forward is the plain version and
the backward autograd through it.  A successful backward on a card adds one
to ``ssd_log_bwd.launches`` and one to each kernel's entry of
``ssd_log_bwd.kernel_launches``.  ``ref.ssd_chunked_bwd_ref`` is the
backward kernels' function in their own decomposition, which the tests
and ``chip_smoke.py`` hold them against.
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
#: `BLOCKS_PER_SM` for the backward's chunk scan.  Its block sums the group's
#: W = M o D once and writes one dB / dC partial a group, so larger groups
#: save work: at both training shapes (Zamba2 and mamba2-130m, 2 x 4096)
#: groups of 16 ran faster than the 8 that two blocks an SM give mamba2.
BWD_BLOCKS_PER_SM = 1


def heads_per_block(batch: int, n_chunks: int, nheads: int, sm_count: int,
                    per_sm: int = BLOCKS_PER_SM) -> int:
    """Heads one block of the chunk kernels owns: `MAX_GROUP` (C Bᵀ computed
    once for 16 heads), halved while the launch would have fewer than
    ``per_sm`` blocks for each of the card's `sm_count` SMs (on an H100's
    132, a 1 x 1000 prefill: 16 chunks, 2 heads).  The backward passes
    `BWD_BLOCKS_PER_SM`."""
    g = MAX_GROUP
    while g > 1 and batch * n_chunks * -(-nheads // g) < per_sm * sm_count:
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
    if log_a.dtype != torch.float32 and not (log_a.dtype == x.dtype == torch.float64
                                             and x.device.type == "cpu"):
        raise ValueError(f"log_a must be float32 (float64 with float64 operands on the CPU, "
                         f"where the plain versions run), got {log_a.dtype}")
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
        return SSDScan.apply(log_a, Bm, Cm, x, chunk, intra_dtype)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(log_a, Bm, Cm, x, chunk, intra_dtype)
    y, state, _ = _forward(log_a, Bm, Cm, x, chunk, intra_dtype)
    return y, state


ssd_log.launches = 0


def _check_card(log_a, Bm, Cm, x, intra_dtype):
    """Raise on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"no ssd kernel for device {x.device}")
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


def _grid(log_a, chunk, device, per_sm=BLOCKS_PER_SM):
    """(sub-chunk length, sub-chunks, heads a block) of a call on a card."""
    b, t, h = log_a.shape
    tile = min(chunk, MAX_TILE)
    n_chunks = -(-t // tile)
    sm = torch.cuda.get_device_properties(device).multi_processor_count
    return tile, n_chunks, heads_per_block(b, n_chunks, h, sm, per_sm)


def _forward(log_a, Bm, Cm, x, chunk, intra_dtype):
    """The forward kernels on a card -> (y, state, (chunk states, decays)):
    the scratch `ssd_log_bwd` reads."""
    _check_card(log_a, Bm, Cm, x, intra_dtype)
    b, t, h = log_a.shape
    n, p = Bm.shape[2], x.shape[3]
    tile, n_chunks, group = _grid(log_a, chunk, x.device)
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=x.device)
    dstate = torch.empty((b, n_chunks, h, n, p), dtype=torch.float32, device=x.device)
    cums = torch.empty((b, n_chunks, h, MAX_TILE), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    _launch(log_a, Bm, Cm, x, y, dstate, cums, state, tile, group)
    ssd_log.launches += 1
    return y, state, (dstate, cums)


class SSDScan(torch.autograd.Function):
    """`ssd_log` with its gradient: on a card the forward kernels, keeping
    their scratch, and the backward kernels (`ssd_log_bwd`); on the CPU the
    plain versions."""

    @staticmethod
    def forward(ctx, log_a, Bm, Cm, x, chunk, intra_dtype):
        ctx.args = (chunk, intra_dtype)
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            ctx.save_for_backward(log_a, Bm, Cm, x)
            return ref.ssd_chunked_ref(log_a, Bm, Cm, x, chunk, intra_dtype)
        y, state, scratch = _forward(log_a, Bm, Cm, x, chunk, intra_dtype)
        ctx.save_for_backward(log_a, Bm, Cm, x, *scratch)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        log_a, Bm, Cm, x, *scratch = ctx.saved_tensors
        chunk, intra_dtype = ctx.args
        grads = ssd_log_bwd(log_a, Bm, Cm, x, dy, dstate, chunk, scratch or None, intra_dtype)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


#: The backward's kernels, in launch order, and their C entry points.
BWD_KERNELS = {"ssd_bwd_state_pass_kernel": "ssd_bwd_state_pass",
               "ssd_bwd_chunk_scan_kernel": "ssd_bwd_chunk_scan",
               "ssd_bwd_reduce_kernel": "ssd_bwd_reduce"}


def ssd_log_bwd(log_a, Bm, Cm, x, dy, dstate, chunk: int = 64, scratch=None,
                intra_dtype: str = "float32"):
    """-> (d log_a, dB, dC, dx, each in its operand's dtype) of `ssd_log`
    at (log_a, B, C, x), given y's gradient ``dy`` (B,T,H,P) and the final
    state's ``dstate`` (B,H,N,P); None for either: zeros.  On the CPU
    autograd through the plain forward, `ref.ssd_chunked_ref`; on a card
    the three backward kernels, no fallback, reading the forward kernels'
    ``scratch`` (the chunk states and the decays that `SSDScan`'s forward
    keeps)."""
    _check(log_a, Bm, Cm, x, chunk)
    if dy is None:
        dy = torch.zeros(x.shape, dtype=log_a.dtype, device=x.device)
    if x.device.type == "cpu":
        inputs = [t.detach().requires_grad_() for t in (log_a, Bm, Cm, x)]
        with torch.enable_grad():
            y, state = ref.ssd_chunked_ref(*inputs, chunk, intra_dtype)
        ys, gs = zip(*[(y, dy)] + ([] if dstate is None else [(state, dstate)]))
        return torch.autograd.grad(ys, inputs, gs)
    outs, calls = bwd_launches(log_a, Bm, Cm, x, dy, dstate, chunk, scratch)
    for kernel, call in calls.items():
        call()
        ssd_log_bwd.kernel_launches[kernel] += 1
    ssd_log_bwd.launches += 1
    return outs[:4]


ssd_log_bwd.launches = 0
ssd_log_bwd.kernel_launches = dict.fromkeys(BWD_KERNELS, 0)


def bwd_launches(log_a, Bm, Cm, x, dy, dstate, chunk, scratch, group=None):
    """Check the backward's operands on a card and allocate its outputs ->
    ((d log_a, dB, dC, dx, dS', part), {kernel: a function that launches it
    and raises if the launch fails}), in `BWD_KERNELS` order.  dS' is the
    (B, n_chunks, H, N, P) float32 scratch that the state pass fills with
    the gradient of the state leaving each chunk (the chunk sums stay in its
    registers); part, (2, B, n_chunks, groups, 64, N) float32, each head
    group's dB and dC, which the last kernel adds in group order (no
    atomics).  The chunk scan's blocks own `heads_per_block` heads under
    `BWD_BLOCKS_PER_SM`, or ``group`` (a sweep's override).  Nothing is
    launched or counted here."""
    _check_card(log_a, Bm, Cm, x, "float32")
    b, t, h = log_a.shape
    n, p = Bm.shape[2], x.shape[3]
    tile, n_chunks, rule = _grid(log_a, chunk, x.device, BWD_BLOCKS_PER_SM)
    group = rule if group is None else group
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"a head group of {group}: need 1 to {MAX_GROUP}")
    if scratch is None:
        raise ValueError("ssd_log_bwd on a card reads the forward kernels' scratch (SSDScan)")
    s_in, cums = scratch
    if (s_in.shape != (b, n_chunks, h, n, p) or cums.shape != (b, n_chunks, h, MAX_TILE)
            or s_in.dtype != torch.float32 or cums.dtype != torch.float32
            or not s_in.is_contiguous() or not cums.is_contiguous()):
        raise ValueError("the forward's scratch does not match the operands")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    dy = dy.to(torch.float32).contiguous()
    if dstate is not None:
        if dstate.shape != (b, h, n, p):
            raise ValueError(f"dstate {tuple(dstate.shape)} must be {(b, h, n, p)}")
        dstate = dstate.to(torch.float32).contiguous()
    dev = x.device
    n_groups = -(-h // group)
    dla = torch.empty((b, t, h), dtype=torch.float32, device=dev)
    dB = torch.empty((b, t, n), dtype=Bm.dtype, device=dev)
    dC = torch.empty((b, t, n), dtype=Cm.dtype, device=dev)
    dx = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    ds_out = torch.empty((b, n_chunks, h, n, p), dtype=torch.float32, device=dev)
    part = torch.empty((2, b, n_chunks, n_groups, MAX_TILE, n), dtype=torch.float32,
                       device=dev)
    # The state pass copies C's rows, the chunk scan x's, by 16 bytes: a view
    # whose rows are not 16-byte aligned (not the model's) is copied first.
    c_pass, x = _rows_16(Cm), _rows_16(x)
    lib = build.library("ssd")
    tail = (int(x.dtype == torch.bfloat16), dev.index, torch.cuda.current_stream(dev).cuda_stream)

    def launcher(kernel, tensors, *rest):
        entry = BWD_KERNELS[kernel]

        def call():   # keeps its tensors (dy's copy too) alive as long as it lives
            err = getattr(lib, entry)(*(None if v is None else v.data_ptr() for v in tensors),
                                      *rest)
            build.check(lib, err, f"{entry} launch")
        return call

    calls = {
        "ssd_bwd_state_pass_kernel": launcher(
            "ssd_bwd_state_pass_kernel", (c_pass, dy, cums, dstate, ds_out), c_pass.stride(0),
            c_pass.stride(1), b, h, t, n, tile, *tail),
        "ssd_bwd_chunk_scan_kernel": launcher(
            "ssd_bwd_chunk_scan_kernel", (Bm, Cm, x, dy, s_in, ds_out, cums, dla, dx, part),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), x.stride(0), x.stride(1),
            x.stride(2), b, h, t, n, tile, group, *tail),
        "ssd_bwd_reduce_kernel": launcher(
            "ssd_bwd_reduce_kernel", (part, dB, dC), b, t, n, tile, n_groups, *tail),
    }
    return (dla, dB, dC, dx, ds_out, part), calls


def _rows_16(t):
    """``t`` if its pointer and its strides but the last are multiples of 16
    bytes, else a contiguous copy (whose rows of 64 or 128 elements are)."""
    esize = t.element_size()
    aligned = t.data_ptr() % 16 == 0 and all(st * esize % 16 == 0 for st in t.stride()[:-1])
    return t if aligned else t.contiguous()


def _launch(log_a, Bm, Cm, x, y, dstate, cums, state, tile: int, group: int) -> None:
    """Call ``csrc/ssd.cu``'s forward entry point on checked operands and
    outputs; raise if it returns an error."""
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
