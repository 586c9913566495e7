"""Wrappers of the hand-written Hopper warp kernels (``csrc/warp.cu``).

Each wrapper checks device, dtype, shape and contiguity, then:

* a CPU tensor goes to the kernel's plain torch version (`ref`);
* a CUDA tensor launches the kernel on ``torch.cuda.current_stream()``, with
  outputs from ``torch.empty``, and raises if the launch returns an error.

There is no fallback from the kernel to the plain version.  Each wrapper
counts its kernel launches in a plain integer attribute, ``launches``,
which only a successful launch increments.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.warp import ref

# The kernels tile output pixels 32 x 8; the grid's y extent caps at 65535.
MAX_NPIX = 65535 * 8


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


def _check_grids(grid_ra, grid_dec, device) -> int:
    _require(grid_ra, "grid_ra", torch.float32, 2, device)
    _require(grid_dec, "grid_dec", torch.float32, 2, device)
    q = grid_ra.shape[0]
    if grid_ra.shape != (q, q) or grid_dec.shape != (q, q):
        raise ValueError(
            f"grids must both be (Q, Q), got {tuple(grid_ra.shape)} and "
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


def _check_scan(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec):
    """Check a pack scan's operands -> (g, cap, h, w, q)."""
    dev = pixels.device
    _require(pixels, "pixels", torch.float32, 4, dev)
    n_packs, cap, h, w = pixels.shape
    _require(wcs_vecs, "wcs_vecs", torch.float32, 3, dev)
    _require(pack_idx, "pack_idx", torch.int32, 1, dev)
    _require(accept, "accept", torch.float32, 2, dev)
    g = pack_idx.shape[0]
    if wcs_vecs.shape != (n_packs, cap, 8) or accept.shape != (g, cap):
        raise ValueError(
            f"wcs_vecs {tuple(wcs_vecs.shape)} / accept {tuple(accept.shape)} do "
            f"not match {n_packs} packs of {cap} slots scanned {g} times"
        )
    if min(n_packs, cap, h, w, g) < 1:
        raise ValueError(
            f"need a non-empty layout and pack_idx, got pixels "
            f"{tuple(pixels.shape)} and {g} packs"
        )
    q = _check_grids(grid_ra, grid_dec, dev)
    lo, hi = (int(v) for v in torch.aminmax(pack_idx))
    if lo < 0 or hi >= n_packs:
        raise IndexError(f"pack_idx spans [{lo}, {hi}], layout has {n_packs} packs")
    return g, cap, h, w, q


def _check_fixed(q, device, **operands):
    """The robust passes' fixed per-pixel operands: (Q,Q) float32 each."""
    for name, t in operands.items():
        _require(t, name, torch.float32, 2, device)
        if t.shape != (q, q):
            raise ValueError(f"{name} must be ({q}, {q}), got {tuple(t.shape)}")


def _launch_scan(entry, scan, dims, outputs, *extra_ints):
    """Launch the pack-scan entry point ``entry`` of csrc/warp.cu.

    ``scan`` is the operands (pixels, wcs_vecs, pack_idx, accept, grid_ra,
    grid_dec) followed by the fixed (Q,Q) operands, ``dims`` (g, cap, h, w, q).
    """
    index, stream = _launch_args(scan[0].device)
    lib = build.library("warp")
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in scan), *(t.data_ptr() for t in outputs),
        *extra_ints, *dims, index, stream,
    )
    build.check(lib, err, f"{entry} launch")


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def coadd_fused(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec):
    """The whole query's map+reduce in ONE launch -> (Q,Q) coadd and depth.

    ``pixels`` (P,cap,H,W) and ``wcs_vecs`` (P,cap,8) are the resident
    layout, ``pack_idx`` (G,) int32 the packs to scan (``arange(P)`` when
    dense), ``accept`` (G,cap) float32 the per-slot weights (acceptance AND
    gate).  Each pack's partial sum is added to the carry in ``pack_idx``
    order, as the reference scan does.
    """
    scan = (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec)
    dims = _check_scan(*scan)
    if pixels.device.type == "cpu":
        return ref.coadd_scan_ref(*scan)
    out = (_empty(grid_ra.shape, pixels), _empty(grid_ra.shape, pixels))
    _launch_scan("coadd_fused_f32", scan, dims, out)
    coadd_fused.launches += 1
    return out


coadd_fused.launches = 0


def coadd_moments(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec):
    """Robust pass 1 in ONE launch -> (S0, S1, S2), each (Q,Q).

    S0 = Σ a·m, S1 = Σ a·vm, S2 = Σ a·vm²/m (m > 0) over every scanned slot;
    operands as `coadd_fused`.
    """
    scan = (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec)
    dims = _check_scan(*scan)
    if pixels.device.type == "cpu":
        return ref.moments_scan_ref(*scan)
    out = tuple(_empty(grid_ra.shape, pixels) for _ in range(3))
    _launch_scan("coadd_moments_f32", scan, dims, out)
    coadd_moments.launches += 1
    return out


coadd_moments.launches = 0


def coadd_clip(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, center, thresh):
    """Robust final pass in ONE launch -> (coadd, depth) of the kept samples.

    A sample is kept where m > 0 and |vm - m·center| <= m·thresh; ``center``
    and ``thresh`` are (Q,Q) float32, the other operands as `coadd_fused`.
    """
    scan = (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec)
    dims = _check_scan(*scan)
    _check_fixed(dims[-1], pixels.device, center=center, thresh=thresh)
    if pixels.device.type == "cpu":
        return ref.clip_scan_ref(*scan, center, thresh)
    out = (_empty(grid_ra.shape, pixels), _empty(grid_ra.shape, pixels))
    _launch_scan("coadd_clip_f32", scan + (center, thresh), dims, out)
    coadd_clip.launches += 1
    return out


coadd_clip.launches = 0

#: Bin counts the ``coadd_hist`` kernel is built for (a template parameter).
HIST_BINS = (8, 16, 32)


def coadd_hist(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, lo, inv_w, nbins=16):
    """Median round 1 in ONE launch -> (nbins,Q,Q) coverage-weighted histogram.

    Each sample adds a·m to bin clip(floor((vm/m - lo)·inv_w), 0, nbins-1);
    ``lo`` and ``inv_w`` are (Q,Q) float32, ``nbins`` one of `HIST_BINS`,
    the other operands as `coadd_fused`.
    """
    if nbins not in HIST_BINS:
        raise ValueError(f"nbins must be one of {HIST_BINS}, got {nbins}")
    scan = (pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec)
    dims = _check_scan(*scan)
    _check_fixed(dims[-1], pixels.device, lo=lo, inv_w=inv_w)
    if pixels.device.type == "cpu":
        return ref.hist_scan_ref(*scan, lo, inv_w, nbins)
    out = _empty((nbins,) + tuple(grid_ra.shape), pixels)
    _launch_scan("coadd_hist_f32", scan + (lo, inv_w), dims, (out,), nbins)
    coadd_hist.launches += 1
    return out


coadd_hist.launches = 0
