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


def coadd_fused(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec):
    """The whole query's map+reduce in ONE launch -> (Q,Q) coadd and depth.

    ``pixels`` (P,cap,H,W) and ``wcs_vecs`` (P,cap,8) are the resident
    layout, ``pack_idx`` (G,) int32 the packs to scan (``arange(P)`` when
    dense), ``accept`` (G,cap) float32 the per-slot weights (acceptance AND
    gate).  Each pack's partial sum is added to the carry in ``pack_idx``
    order, as the reference scan does.
    """
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
    if dev.type == "cpu":
        return ref.coadd_scan_ref(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec)
    index, stream = _launch_args(dev)
    lib = build.library("warp")
    coadd = torch.empty((q, q), dtype=torch.float32, device=dev)
    depth = torch.empty((q, q), dtype=torch.float32, device=dev)
    err = lib.coadd_fused_f32(
        pixels.data_ptr(), wcs_vecs.data_ptr(), pack_idx.data_ptr(),
        accept.data_ptr(), grid_ra.data_ptr(), grid_dec.data_ptr(),
        coadd.data_ptr(), depth.data_ptr(),
        g, cap, h, w, q, index, stream,
    )
    build.check(lib, err, "coadd_fused launch")
    coadd_fused.launches += 1
    return coadd, depth


coadd_fused.launches = 0
