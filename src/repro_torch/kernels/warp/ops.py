"""Wrappers of the hand-written Hopper warp, PSF-matching and brick-mosaic
kernels (``csrc/warp.cu``, ``csrc/psf.cu``, ``csrc/mosaic.cu``).

Each wrapper checks device, dtype, shape and contiguity, then:

* a CPU tensor goes to the kernel's plain torch version (`ref`);
* a CUDA tensor launches the kernel on ``torch.cuda.current_stream()``, with
  outputs from ``torch.empty``, and raises if the launch returns an error.

There is no fallback from the kernel to the plain version.  Each wrapper
counts its kernel launches in a plain integer attribute, ``launches``,
which only a successful launch increments.

PSF matching is a pre-pass: `psf_match` writes the query's scanned packs,
each frame correlated with its slot's kernel, to a (G, cap, H, W) scratch,
and the pack scans read that scratch (`matched_packs`).  The scans'
``psf_kernels`` argument composes the two: one ``psf_match`` call, then the
pass (on the CPU both are plain versions).  Given the scan's ``accept``
and the scratch's flag, `matched_packs` gives the pre-pass a (G, cap) uint8
``skip`` (`prepass_skip`): rejected slots whose flag is set, which no culled
pass reads, are written as zeros and not matched.  The ``psf_match*``
wrappers take that ``skip`` as it is, or None to match every slot.

The pack index is checked against the layout on a host copy: the pack
scans and the ``psf_match*`` wrappers take ``host_idx``, the numpy array
the caller uploaded ``pack_idx`` from, so a launch needs no host sync;
without it a CPU index is read in place and a CUDA one copied back once.

``warp_batch`` launches the culled ``warp_project_kernel``: a (tile, image)
pair whose footprint misses the tile is written without sampling, the same
bits as the unculled kernel (``warp_project_unculled_f32``), which only
``chip_smoke.py`` launches.

The pack scans launch ``pack_scan_kernel`` (the header of
``csrc/warp.cu``), which culls the whole scan in each block before it
samples: a rejected slot whose ``finite`` flag is set (a (P, cap) uint8
tensor, `seqfile.finite_slots`; the PSF scratch's flag is
`matched_finite`) is no candidate, and a candidate whose footprint misses
the block's tile is not kept.  The block samples the kept slots in scan
order and frames only the packs that hold one.  What it skips adds exact
zeros, so the result is bitwise the unculled scan's
(``pack_scan_unculled_kernel``), which only ``chip_smoke.py`` launches.

Batches (paper Fig. 5): ``coadd_fused_batch``, ``coadd_moments_batch``,
``coadd_clip_batch`` and ``coadd_hist_batch`` run K queries over one pack
index in ONE launch of the query-axis ``pack_scan_kernel``: ``accept`` is
(K, G, cap), the grids and fixed operands (K, Q, Q), and the outputs gain a
leading K.  Each query is bitwise its own one-query launch on the same
operands.  With a bank, the batch's one ``psf_match`` pre-pass skips only
the slots every query rejects (`prepass_skip` of the (K, G, cap) accept).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.warp import ref

# The kernels tile output pixels 32 x 8; the grid's y extent caps at 65535.
MAX_NPIX = 65535 * 8
#: Most taps a PSF-matching kernel takes along each axis: the kernels' staged
#: windows are sized for it (83 KB of shared memory for the separable kernel
#: at 49 taps, csrc/psf.cu).
MAX_TAPS = 49


def _require(t, name: str, dtype: torch.dtype, ndim: int, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_grids(grid_ra, grid_dec, device, lead=()) -> int:
    """The output grids: (Q, Q) each, or (K, Q, Q) for ``lead`` (K,)."""
    _require(grid_ra, "grid_ra", torch.float32, 2 + len(lead), device)
    _require(grid_dec, "grid_dec", torch.float32, 2 + len(lead), device)
    q = grid_ra.shape[-1]
    want = tuple(lead) + (q, q)
    if grid_ra.shape != want or grid_dec.shape != want:
        raise ValueError(
            f"grids must both be {'(K, Q, Q)' if lead else '(Q, Q)'} for K = "
            f"{lead[0] if lead else 1}, got {tuple(grid_ra.shape)} and "
            f"{tuple(grid_dec.shape)}"
        )
    if not 1 <= q <= MAX_NPIX:
        raise ValueError(f"npix must be in [1, {MAX_NPIX}], got {q}")
    return q


def _launch_args(device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"no warp kernel for device {device}")
    return device.index, torch.cuda.current_stream(device).cuda_stream


def warp_batch(pixels, wcs_vecs, accepts, grid_ra, grid_dec):
    """(N,H,W) images -> (N,Q,Q) projected tiles and coverages.

    The ``warp_project`` kernel: one launch for the whole batch, over the
    grid (output tile, image).
    """
    dev = pixels.device
    _require(pixels, "pixels", torch.float32, 3, dev)
    n, h, w = pixels.shape
    _require(wcs_vecs, "wcs_vecs", torch.float32, 2, dev)
    _require(accepts, "accepts", torch.float32, 1, dev)
    if wcs_vecs.shape != (n, 8) or accepts.shape != (n,):
        raise ValueError(
            f"wcs_vecs {tuple(wcs_vecs.shape)} / accepts {tuple(accepts.shape)} "
            f"do not match {n} images"
        )
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"pixels must be non-empty, got {tuple(pixels.shape)}")
    q = _check_grids(grid_ra, grid_dec, dev)
    if dev.type == "cpu":
        return ref.warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec)
    index, stream = _launch_args(dev)
    lib = build.library("warp")
    tile = torch.empty((n, q, q), dtype=torch.float32, device=dev)
    cov = torch.empty((n, q, q), dtype=torch.float32, device=dev)
    err = lib.warp_project_f32(
        pixels.data_ptr(), wcs_vecs.data_ptr(), accepts.data_ptr(),
        grid_ra.data_ptr(), grid_dec.data_ptr(), tile.data_ptr(), cov.data_ptr(),
        n, h, w, q, index, stream,
    )
    build.check(lib, err, "warp_project launch")
    warp_batch.launches += 1
    return tile, cov


warp_batch.launches = 0


def _check_pack_idx(pack_idx, n_packs, host_idx=None):
    """Every entry of the (G,) index in [0, n_packs), checked on the host:
    on ``host_idx`` (the array ``pack_idx`` was uploaded from; its length
    must match), else on ``pack_idx`` itself on the CPU, else on one copy
    of it to the host (a sync)."""
    if host_idx is None:
        host_idx = pack_idx.cpu()
    host_idx = np.asarray(host_idx)
    if host_idx.shape != tuple(pack_idx.shape):
        raise ValueError(f"host_idx {host_idx.shape} does not match pack_idx "
                         f"{tuple(pack_idx.shape)}")
    lo, hi = int(host_idx.min()), int(host_idx.max())
    if lo < 0 or hi >= n_packs:
        raise IndexError(f"pack_idx spans [{lo}, {hi}], layout has {n_packs} packs")


def _check_bank(pixels, pack_idx, bank, ndim, skip=None, host_idx=None):
    """Check a PSF-matching pre-pass's operands -> (g, cap, h, w).

    ``bank`` is (P, cap, K) separable rows (``ndim`` 3) or (P, cap, Kh, Kw)
    taps (``ndim`` 4), odd widths of at most `MAX_TAPS`; ``skip`` None or a
    (G, cap) uint8 flag.
    """
    dev = pixels.device
    _require(pixels, "pixels", torch.float32, 4, dev)
    n_packs, cap, h, w = pixels.shape
    _require(pack_idx, "pack_idx", torch.int32, 1, dev)
    _require(bank, "psf_kernels", torch.float32, ndim, dev)
    taps = tuple(bank.shape[2:])
    if tuple(bank.shape[:2]) != (n_packs, cap):
        raise ValueError(f"psf_kernels {tuple(bank.shape)} do not match {n_packs} packs of "
                         f"{cap} slots")
    if any(k % 2 == 0 or not 1 <= k <= MAX_TAPS for k in taps):
        raise ValueError(f"psf_kernels widths must be odd and in [1, {MAX_TAPS}], got {taps}")
    g = pack_idx.shape[0]
    if min(n_packs, cap, h, w, g) < 1 or g * cap >= 2**31:
        raise ValueError(f"need a non-empty layout and pack_idx, got pixels "
                         f"{tuple(pixels.shape)} and {g} packs")
    _check_pack_idx(pack_idx, n_packs, host_idx)
    if skip is not None:
        _require(skip, "skip", torch.uint8, 2, dev)
        if tuple(skip.shape) != (g, cap):
            raise ValueError(f"skip {tuple(skip.shape)} does not match {g} packs of {cap} slots")
    return g, cap, h, w


def _launch_psf(entry, pixels, pack_idx, bank, skip, dims, taps):
    g, cap, h, w = dims
    index, stream = _launch_args(pixels.device)
    lib = build.library("psf")
    out = torch.empty((g, cap, h, w), dtype=torch.float32, device=pixels.device)
    err = getattr(lib, entry)(pixels.data_ptr(), pack_idx.data_ptr(), bank.data_ptr(),
                              None if skip is None else skip.data_ptr(), out.data_ptr(),
                              g * cap, cap, h, w, *taps, index, stream)
    build.check(lib, err, f"{entry} launch")
    return out


def psf_match_sep(pixels, pack_idx, psf_kernels, skip=None, *, host_idx=None):
    """(G, cap, H, W) frames of the packs ``pack_idx``, each correlated with its
    slot's (K,) row of the (P, cap, K) bank along W, then along H; zeros
    where the (G, cap) uint8 ``skip`` is set.

    ONE launch of ``psf_match_sep_kernel``; edge-clamped, as
    ``psf.convolve_batch`` (its plain version, via `ref.psf_match_ref`).
    """
    dims = _check_bank(pixels, pack_idx, psf_kernels, 3, skip, host_idx)
    if pixels.device.type == "cpu":
        return ref.psf_match_ref(pixels, pack_idx, psf_kernels, skip)
    out = _launch_psf("psf_match_sep_f32", pixels, pack_idx, psf_kernels, skip, dims,
                      psf_kernels.shape[2:])
    psf_match_sep.launches += 1
    return out


psf_match_sep.launches = 0


def psf_match_2d(pixels, pack_idx, psf_kernels, skip=None, *, host_idx=None):
    """(G, cap, H, W) frames of the packs ``pack_idx``, each correlated with its
    slot's (Kh, Kw) taps of the (P, cap, Kh, Kw) bank; zeros where the
    (G, cap) uint8 ``skip`` is set.

    ONE launch of ``psf_match_2d_kernel``; edge-clamped, as
    ``psf.convolve_batch`` (its plain version, via `ref.psf_match_ref`).
    """
    dims = _check_bank(pixels, pack_idx, psf_kernels, 4, skip, host_idx)
    if pixels.device.type == "cpu":
        return ref.psf_match_ref(pixels, pack_idx, psf_kernels, skip)
    out = _launch_psf("psf_match_2d_f32", pixels, pack_idx, psf_kernels, skip, dims,
                      psf_kernels.shape[2:])
    psf_match_2d.launches += 1
    return out


psf_match_2d.launches = 0


def psf_match(pixels, pack_idx, psf_kernels, skip=None, *, host_idx=None):
    """The PSF-matching pre-pass for either bank rank: `psf_match_sep` for a
    (P, cap, K) bank, `psf_match_2d` for a (P, cap, Kh, Kw) one."""
    if isinstance(psf_kernels, torch.Tensor) and psf_kernels.dim() == 4:
        return psf_match_2d(pixels, pack_idx, psf_kernels, skip, host_idx=host_idx)
    return psf_match_sep(pixels, pack_idx, psf_kernels, skip, host_idx=host_idx)


#: Largest gain of a slot's PSF-matching kernel (the sum of |taps|; a
#: separable row's square, the gain of its 2-D kernel) under which the
#: matched frame of a flagged slot keeps the flag.  A matched pixel is then
#: at most 3.5 * 2**62 * (1 + 2 * MAX_TAPS * 2**-24) < 0.88 * 2**64 in
#: magnitude, so vm*vm stays finite in every pass.  The survey's measured
#: homogenization kernels reach gains of about 2.5.
MAX_MATCH_GAIN = 3.5


def matched_finite(finite, pack_idx, psf_kernels):
    """The (G, cap) uint8 ``finite`` flag of the PSF scratch `matched_packs`
    writes: the source slot's flag, kept where its kernel's gain is at most
    `MAX_MATCH_GAIN` (a reduction over the bank, not a pass over the
    scratch)."""
    taps = psf_kernels.abs().flatten(2).sum(-1)
    gain = taps * taps if psf_kernels.dim() == 3 else taps
    ok = (finite != 0) & (gain <= MAX_MATCH_GAIN)
    return ok[pack_idx.to(torch.int64)].to(torch.uint8)


def prepass_skip(accept, matched_flag):
    """The pre-pass's (G, cap) uint8 ``skip``: rejected slots (accept 0) whose
    PSF scratch flag (`matched_finite`) is set.  The culled passes skip
    exactly those (rule (a) of csrc/warp.cu), so their matched pixels are
    never read; a rejected slot without the flag is still matched, NaNs and
    all, as the passes sample it.  A batch's (K, G, cap) accept skips a slot
    only when every query rejects it: one that any query accepts is read."""
    rejected = accept == 0
    if rejected.dim() == 3:
        rejected = rejected.all(dim=0)
    return (rejected & (matched_flag != 0)).to(torch.uint8)


def matched_packs(pixels, wcs_vecs, pack_idx, psf_kernels, accept=None, matched_flag=None, *,
                  host_idx=None):
    """The scan operands over a query's PSF-matched packs -> (pixels, wcs_vecs,
    pack_idx) for the pack scans.

    One `psf_match` launch writes the (G, cap, H, W) scratch; the scan then
    reads it with its own (G, cap, 8) WCS rows and pack index ``arange(G)``
    (a pack scan takes one base, pack_idx[g] * cap, for both pixels and WCS).
    Given the scan's (G, cap) ``accept`` (a batch's (K, G, cap)) and the
    scratch's flag (`matched_finite`), the slots no culled pass reads
    (`prepass_skip`) are written as zeros and not matched; without them
    every slot is matched.
    """
    skip = None
    if accept is not None and matched_flag is not None:
        skip = prepass_skip(accept, matched_flag)
    matched = psf_match(pixels, pack_idx, psf_kernels, skip, host_idx=host_idx)
    wcs = wcs_vecs[pack_idx.to(torch.int64)]
    idx = torch.arange(pack_idx.shape[0], dtype=torch.int32, device=pack_idx.device)
    return matched, wcs, idx


#: Most queries one batched launch takes (the grid's z extent).
MAX_QUERIES = 65535


def _check_scan(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, batched=False,
                host_idx=None):
    """Check a pack scan's operands -> (g, cap, h, w, q).  ``batched``: a
    (K, G, cap) accept and (K, Q, Q) grids; ``host_idx`` as
    `_check_pack_idx`."""
    dev = pixels.device
    _require(pixels, "pixels", torch.float32, 4, dev)
    n_packs, cap, h, w = pixels.shape
    _require(wcs_vecs, "wcs_vecs", torch.float32, 3, dev)
    _require(pack_idx, "pack_idx", torch.int32, 1, dev)
    _require(accept, "accept", torch.float32, 2 + batched, dev)
    g = pack_idx.shape[0]
    lead = tuple(accept.shape[:1]) if batched else ()
    if wcs_vecs.shape != (n_packs, cap, 8) or accept.shape != lead + (g, cap):
        raise ValueError(
            f"wcs_vecs {tuple(wcs_vecs.shape)} / accept {tuple(accept.shape)} do "
            f"not match {n_packs} packs of {cap} slots scanned {g} times"
        )
    if min(n_packs, cap, h, w, g) < 1:
        raise ValueError(
            f"need a non-empty layout and pack_idx, got pixels "
            f"{tuple(pixels.shape)} and {g} packs"
        )
    if batched and not 1 <= lead[0] <= MAX_QUERIES:
        raise ValueError(f"a batch takes 1 to {MAX_QUERIES} queries, got {lead[0]}")
    q = _check_grids(grid_ra, grid_dec, dev, lead)
    _check_pack_idx(pack_idx, n_packs, host_idx)
    return g, cap, h, w, q


def _prepare_scan(scan, psf_kernels, finite, batched=False, host_idx=None, **fixed):
    """Check a pass's operands -> (scan, dims, finite); with a bank, the scan
    over the PSF-matched packs (`matched_packs`, gated by the flag) and
    their flag (`matched_finite`).  ``fixed`` are the pass's (Q,Q)
    operands, (K,Q,Q) when ``batched``; ``host_idx`` as `_check_pack_idx`."""
    dims = _check_scan(*scan, batched=batched, host_idx=host_idx)
    _check_fixed(dims[-1], scan[0].device, tuple(scan[3].shape[:1]) if batched else (),
                 **fixed)
    if finite is not None:
        _require(finite, "finite", torch.uint8, 2, scan[0].device)
        if tuple(finite.shape) != tuple(scan[0].shape[:2]):
            raise ValueError(f"finite {tuple(finite.shape)} does not match the layout's "
                             f"{tuple(scan[0].shape[:2])} slots")
    if psf_kernels is not None:
        if finite is not None:
            finite = matched_finite(finite, scan[2], psf_kernels)
        scan = matched_packs(*scan[:3], psf_kernels, scan[3], finite,
                             host_idx=host_idx) + scan[3:]
    return scan, dims, finite


def _check_fixed(q, device, lead=(), **operands):
    """The robust passes' fixed per-pixel operands: (Q,Q) float32 each, or
    (K,Q,Q) for ``lead`` (K,)."""
    want = tuple(lead) + (q, q)
    for name, t in operands.items():
        _require(t, name, torch.float32, len(want), device)
        if t.shape != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")


def _launch_pass(kind, nbins, scan, fixed, finite, dims, outputs):
    """Launch the culled pack scan ``pack_scan_f32`` (csrc/warp.cu): pass
    ``kind`` (0 fused, 1 moments, 2 clip, 3 hist) over ``scan`` = (pixels,
    wcs_vecs, pack_idx, accept, grid_ra, grid_dec), with the (Q,Q) operands
    ``fixed``, the slot flag ``finite`` or None, ``dims`` (g, cap, h, w, q).
    A (K, G, cap) accept with (K, Q, Q) grids, operands and outputs runs K
    queries in the one launch; a (G, cap) one is K = 1."""
    index, stream = _launch_args(scan[0].device)
    lib = build.library("warp")
    ins = [t.data_ptr() for t in fixed] + [None] * (2 - len(fixed))
    outs = [t.data_ptr() for t in outputs] + [None] * (3 - len(outputs))
    n_queries = scan[3].shape[0] if scan[3].dim() == 3 else 1
    err = lib.pack_scan_f32(
        kind, nbins, *(t.data_ptr() for t in scan[:4]),
        None if finite is None else finite.data_ptr(), *(t.data_ptr() for t in scan[4:]),
        *ins, *outs, n_queries, *dims, index, stream,
    )
    build.check(lib, err, "pack_scan_f32 launch")


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def coadd_fused(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, psf_kernels=None, *,
                finite=None, host_idx=None):
    """The whole query's map+reduce in ONE launch -> (Q,Q) coadd and depth.

    ``pixels`` (P,cap,H,W) and ``wcs_vecs`` (P,cap,8) are the resident
    layout, ``pack_idx`` (G,) int32 the packs to scan (``arange(P)`` when
    dense), ``accept`` (G,cap) float32 the per-slot weights (acceptance AND
    gate).  Each pack's partial sum is added to the carry in ``pack_idx``
    order, as the reference scan does.  With a ``psf_kernels`` bank
    ((P,cap,K) or (P,cap,Kh,Kw)) the frames are PSF-matched first: one
    `psf_match` launch, then the scan.  ``finite`` is the layout's (P,cap)
    uint8 slot flag (`seqfile.finite_slots`): with it the kernel also skips
    rejected flagged slots; the result is the same bits either way.
    ``host_idx`` is the host array ``pack_idx`` was uploaded from: the index
    is checked there, with no host sync.
    """
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec), psf_kernels, finite,
        host_idx=host_idx)
    if pixels.device.type == "cpu":
        return ref.coadd_scan_ref(*scan)
    out = (_empty(grid_ra.shape, pixels), _empty(grid_ra.shape, pixels))
    _launch_pass(0, 0, scan, (), finite, dims, out)
    coadd_fused.launches += 1
    return out


coadd_fused.launches = 0


def coadd_moments(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, psf_kernels=None,
                  *, finite=None, host_idx=None):
    """Robust pass 1 in ONE launch -> (S0, S1, S2), each (Q,Q).

    S0 = Σ a·m, S1 = Σ a·vm, S2 = Σ a·vm²/m (m > 0) over every scanned slot;
    operands as `coadd_fused`.
    """
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec), psf_kernels, finite,
        host_idx=host_idx)
    if pixels.device.type == "cpu":
        return ref.moments_scan_ref(*scan)
    out = tuple(_empty(grid_ra.shape, pixels) for _ in range(3))
    _launch_pass(1, 0, scan, (), finite, dims, out)
    coadd_moments.launches += 1
    return out


coadd_moments.launches = 0


def coadd_clip(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, center, thresh,
               psf_kernels=None, *, finite=None, host_idx=None):
    """Robust final pass in ONE launch -> (coadd, depth) of the kept samples.

    A sample is kept where m > 0 and |vm - m·center| <= m·thresh; ``center``
    and ``thresh`` are (Q,Q) float32, the other operands as `coadd_fused`.
    """
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec), psf_kernels, finite,
        host_idx=host_idx, center=center, thresh=thresh)
    if pixels.device.type == "cpu":
        return ref.clip_scan_ref(*scan, center, thresh)
    out = (_empty(grid_ra.shape, pixels), _empty(grid_ra.shape, pixels))
    _launch_pass(2, 0, scan, (center, thresh), finite, dims, out)
    coadd_clip.launches += 1
    return out


coadd_clip.launches = 0

#: Bin counts the ``coadd_hist`` kernel is built for (a template parameter).
HIST_BINS = (8, 16, 32)


def coadd_hist(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, lo, inv_w, nbins=16,
               psf_kernels=None, *, finite=None, host_idx=None):
    """Median round 1 in ONE launch -> (nbins,Q,Q) coverage-weighted histogram.

    Each sample adds a·m to bin clip(floor((vm/m - lo)·inv_w), 0, nbins-1);
    ``lo`` and ``inv_w`` are (Q,Q) float32, ``nbins`` one of `HIST_BINS`,
    the other operands as `coadd_fused`.
    """
    if nbins not in HIST_BINS:
        raise ValueError(f"nbins must be one of {HIST_BINS}, got {nbins}")
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec), psf_kernels, finite,
        host_idx=host_idx, lo=lo, inv_w=inv_w)
    if pixels.device.type == "cpu":
        return ref.hist_scan_ref(*scan, lo, inv_w, nbins)
    out = _empty((nbins,) + tuple(grid_ra.shape), pixels)
    _launch_pass(3, nbins, scan, (lo, inv_w), finite, dims, (out,))
    coadd_hist.launches += 1
    return out


coadd_hist.launches = 0


def coadd_fused_batch(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                      psf_kernels=None, *, finite=None, host_idx=None):
    """K queries' map+reduce over one pack index in ONE launch -> (K,Q,Q)
    coadds and depths.

    ``accepts`` (K,G,cap) float32 and ``grids_ra``/``grids_dec`` (K,Q,Q) are
    each query's; the layout, ``pack_idx``, a bank and ``finite`` are shared,
    as in `coadd_fused`.  Query k is bitwise `coadd_fused` on its own accept
    and grids.
    """
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec), psf_kernels, finite,
        batched=True, host_idx=host_idx)
    if pixels.device.type == "cpu":
        return ref.coadd_scan_batch_ref(*scan)
    out = (_empty(grids_ra.shape, pixels), _empty(grids_ra.shape, pixels))
    _launch_pass(0, 0, scan, (), finite, dims, out)
    coadd_fused_batch.launches += 1
    return out


coadd_fused_batch.launches = 0


def coadd_moments_batch(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                        psf_kernels=None, *, finite=None, host_idx=None):
    """Robust pass 1 for K queries in ONE launch -> (S0, S1, S2), each
    (K,Q,Q); operands as `coadd_fused_batch`."""
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec), psf_kernels, finite,
        batched=True, host_idx=host_idx)
    if pixels.device.type == "cpu":
        return ref.moments_scan_batch_ref(*scan)
    out = tuple(_empty(grids_ra.shape, pixels) for _ in range(3))
    _launch_pass(1, 0, scan, (), finite, dims, out)
    coadd_moments_batch.launches += 1
    return out


coadd_moments_batch.launches = 0


def coadd_clip_batch(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec, centers,
                     threshs, psf_kernels=None, *, finite=None, host_idx=None):
    """Robust final pass for K queries in ONE launch -> (K,Q,Q) coadds and
    depths of the kept samples; ``centers``/``threshs`` (K,Q,Q) float32, the
    other operands as `coadd_fused_batch`."""
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec), psf_kernels, finite,
        batched=True, host_idx=host_idx, center=centers, thresh=threshs)
    if pixels.device.type == "cpu":
        return ref.clip_scan_batch_ref(*scan, centers, threshs)
    out = (_empty(grids_ra.shape, pixels), _empty(grids_ra.shape, pixels))
    _launch_pass(2, 0, scan, (centers, threshs), finite, dims, out)
    coadd_clip_batch.launches += 1
    return out


coadd_clip_batch.launches = 0


def coadd_hist_batch(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec, los, inv_ws,
                     nbins=16, psf_kernels=None, *, finite=None, host_idx=None):
    """Median round 1 for K queries in ONE launch -> (K,nbins,Q,Q)
    histograms; ``los``/``inv_ws`` (K,Q,Q) float32, ``nbins`` one of
    `HIST_BINS`, the other operands as `coadd_fused_batch`."""
    if nbins not in HIST_BINS:
        raise ValueError(f"nbins must be one of {HIST_BINS}, got {nbins}")
    scan, dims, finite = _prepare_scan(
        (pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec), psf_kernels, finite,
        batched=True, host_idx=host_idx, lo=los, inv_w=inv_ws)
    if pixels.device.type == "cpu":
        return ref.hist_scan_batch_ref(*scan, los, inv_ws, nbins)
    k, q = grids_ra.shape[0], grids_ra.shape[-1]
    out = _empty((k, nbins, q, q), pixels)
    _launch_pass(3, nbins, scan, (los, inv_ws), finite, dims, (out,))
    coadd_hist_batch.launches += 1
    return out


coadd_hist_batch.launches = 0


def mosaic_bricks(tiles, covs, offsets, npix: int):
    """(B,bh,bw) brick tiles and weight maps -> (npix,npix) coadd and depth.

    ONE launch of ``mosaic_bricks_kernel``: each tile added into zero
    canvases at its (B,2) int32 (row, col) offset, in brick order, so
    overlapping tiles sum in that order; a negative offset counts once from
    the end, then each is clamped to ``[0, npix - bh] x [0, npix - bw]``
    (the reference's placement).  Uncovered pixels are 0 and B = 0 gives
    zero canvases.  Bitwise its plain version, `ref.mosaic_bricks_ref`.
    """
    dev = tiles.device
    _require(tiles, "tiles", torch.float32, 3, dev)
    _require(covs, "covs", torch.float32, 3, dev)
    _require(offsets, "offsets", torch.int32, 2, dev)
    b, bh, bw = tiles.shape
    if covs.shape != tiles.shape or offsets.shape != (b, 2):
        raise ValueError(f"covs {tuple(covs.shape)} / offsets {tuple(offsets.shape)} do not "
                         f"match tiles {tuple(tiles.shape)}")
    npix = int(npix)
    if not 1 <= npix <= MAX_NPIX:
        raise ValueError(f"npix must be in [1, {MAX_NPIX}], got {npix}")
    if not (1 <= bh <= npix and 1 <= bw <= npix):
        raise ValueError(f"tiles ({bh}, {bw}) do not fit an ({npix}, {npix}) canvas")
    if dev.type == "cpu":
        return ref.mosaic_bricks_ref(tiles, covs, offsets, npix)
    index, stream = _launch_args(dev)
    lib = build.library("mosaic")
    coadd = torch.empty((npix, npix), dtype=torch.float32, device=dev)
    depth = torch.empty((npix, npix), dtype=torch.float32, device=dev)
    err = lib.mosaic_bricks_f32(tiles.data_ptr(), covs.data_ptr(), offsets.data_ptr(),
                                coadd.data_ptr(), depth.data_ptr(), b, bh, bw, npix,
                                index, stream)
    build.check(lib, err, "mosaic_bricks launch")
    mosaic_bricks.launches += 1
    return coadd, depth


mosaic_bricks.launches = 0
