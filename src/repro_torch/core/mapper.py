"""Map stage: per-image filter + projection onto the query grid.

Counterpart of ``repro.core.mapper`` in torch.  Faithful to Algorithm 2: the
mapper receives one image, checks bandpass and bounds overlap, and — when
accepted — projects the image onto the query's common coordinate system,
emitting a projected tile plus its coverage footprint.  Rejected images
emit zeros (val * 0): the masked discard of paper Fig. 6.

The projection is an *inverse* warp: for every output pixel its sky
position is computed once per query, then per image sky -> source pixel via
the image's TAN WCS, and a bilinear sample.  The functions here are the
plain torch versions; ``map_batch(use_kernel=True)`` sends a CUDA batch to
the hand-written ``warp_project`` kernel instead.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import psf
from repro_torch.core.geometry import pixel_to_sky, sky_to_pixel
from repro_torch.core.query import CoaddQuery


def query_grid_sky(query: CoaddQuery) -> Tuple[np.ndarray, np.ndarray]:
    """Sky coordinates (ra, dec), each (npix, npix) float32, of the output grid.

    Depends only on the query — computed once per job on the host (numpy,
    bitwise equal to the reference).
    """
    n = query.npix
    g = query.grid_wcs_vector().astype(np.float64)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    ra, dec = pixel_to_sky(xs, ys, g)
    return ra.astype(np.float32), dec.astype(np.float32)


def bilinear_sample(image: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Bilinear interpolation of `image` at float coords (sx, sy).

    ``image`` is (..., H, W) and ``sx``/``sy`` are (..., Q, Q) with the same
    leading dims.  Returns (values * inside, inside): out-of-bounds samples
    give 0 with mask 0, so coverage counts only true source pixels.

    Neighbour indices clamp to the image edge exactly as the reference does.
    Coordinates are first clamped into [-1, W] x [-1, H] (NaN to -1, as
    CUDA's ``fmaxf`` does) so the float->int conversion is defined for any
    sx; ``inside`` is decided on the unclamped values, so every sample the
    reference defines is unchanged.

    An uncovered sample is exactly 0, never ``val * 0``: the reference's
    jitted program rewrites a product with a converted mask into a select,
    so an empty slot, whose all-zero WCS gives det 0 and a NaN sx, adds
    nothing.
    """
    h, w = image.shape[-2:]
    sxc = torch.fmin(torch.fmax(sx, sx.new_tensor(-1.0)), sx.new_tensor(float(w)))
    syc = torch.fmin(torch.fmax(sy, sy.new_tensor(-1.0)), sy.new_tensor(float(h)))
    x0 = torch.floor(sxc)
    y0 = torch.floor(syc)
    dx = sxc - x0
    dy = syc - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    inside = (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)

    x0c = x0i.clamp(0, w - 1)
    x1c = (x0i + 1).clamp(0, w - 1)
    y0c = y0i.clamp(0, h - 1)
    y1c = (y0i + 1).clamp(0, h - 1)

    lead = image.shape[:-2]
    flat = image.reshape(*lead, h * w)

    def at(yc, xc):
        idx = (yc * w + xc).reshape(*lead, -1)
        return torch.gather(flat, -1, idx).reshape(sx.shape)

    v00 = at(y0c, x0c)
    v01 = at(y0c, x1c)
    v10 = at(y1c, x0c)
    v11 = at(y1c, x1c)
    val = (
        v00 * (1 - dx) * (1 - dy)
        + v01 * dx * (1 - dy)
        + v10 * (1 - dx) * dy
        + v11 * dx * dy
    )
    return torch.where(inside, val, 0.0), inside.to(image.dtype)


def project_one(
    pixels: torch.Tensor,       # (H, W)
    wcs_vec: torch.Tensor,      # (8,)
    accept: torch.Tensor,       # scalar bool/float: band+bounds+time+valid gate
    grid_ra: torch.Tensor,      # (Q, Q)
    grid_dec: torch.Tensor,     # (Q, Q)
):
    """Project one image onto the query grid. Returns (tile, coverage)."""
    sx, sy = sky_to_pixel(grid_ra, grid_dec, wcs_vec)
    val, cov = bilinear_sample(pixels, sx, sy)
    a = torch.as_tensor(accept, device=pixels.device).to(pixels.dtype)
    return val * a, cov * a


def project_batch(
    pixels: torch.Tensor,       # (N, H, W)
    wcs_vecs: torch.Tensor,     # (N, 8)
    accept: torch.Tensor,       # (N,)
    grid_ra: torch.Tensor,      # (Q, Q), or any shape of sky points
    grid_dec: torch.Tensor,     # like grid_ra
):
    """`project_one` over a batch, written out along a leading image axis."""
    n = pixels.shape[0]
    lead = (n,) + (1,) * grid_ra.dim()
    sx, sy = sky_to_pixel(grid_ra, grid_dec, wcs_vecs.T.reshape(8, *lead))
    val, cov = bilinear_sample(pixels, sx, sy)
    a = accept.to(pixels.dtype).reshape(lead)
    return val * a, cov * a


def acceptance_mask(
    band_id, valid, t_obs, ra_min, ra_max, dec_min, dec_max, query: CoaddQuery
):
    """Vectorized Algorithm-2 acceptance test over a batch of images."""
    ra0, ra1 = query.ra_bounds
    dec0, dec1 = query.dec_bounds
    t0, t1 = query.time_window()
    return (
        (band_id == query.band_id)
        & valid
        & (ra_max >= ra0)
        & (ra_min <= ra1)
        & (dec_max >= dec0)
        & (dec_min <= dec1)
        & (t_obs >= t0)
        & (t_obs <= t1)
    )


def gather_packs(pack_idx, pixels, wcs_vecs, ints: dict, floats: dict, psf_kernels=None):
    """Take pack(s) ``pack_idx`` out of the resident (P, cap, ...) tensors.

    An int gives views of one pack; an index tensor gives (G, cap, ...)
    copies.  Padding entries of a sparse index duplicate pack 0; the
    compacted gate rejects their slots, so they contribute exact zeros.
    Returns (pixels, wcs, ints, floats, psf_kernels), the last None when no
    (P, cap, K) or (P, cap, K, K) bank is given.
    """
    if isinstance(pack_idx, torch.Tensor):
        pack_idx = pack_idx.to(torch.int64)
    take = lambda a: a[pack_idx]  # noqa: E731
    return (
        take(pixels),
        take(wcs_vecs),
        {k: take(v) for k, v in ints.items()},
        {k: take(v) for k, v in floats.items()},
        None if psf_kernels is None else take(psf_kernels),
    )


def map_batch(
    pixels: torch.Tensor,     # (N, H, W)
    wcs_vecs: torch.Tensor,   # (N, 8)
    accept: torch.Tensor,     # (N,)
    grid_ra: torch.Tensor,
    grid_dec: torch.Tensor,
    use_kernel: bool = False,
    psf_kernels=None,         # (N, K) separable rows or (N, K, K) taps
):
    """Map stage over a batch of images -> (tiles, coverages), each (N, Q, Q).

    With ``psf_kernels`` each image is first PSF-matched to the common
    target (`psf.convolve_batch`; the bank's rank picks separable or 2-D).
    ``use_kernel=True`` goes through the wrappers instead: one
    ``psf_match`` launch for the bank, then one launch of the hand-written
    ``warp_project`` kernel, for a CUDA batch.
    """
    if use_kernel:
        from repro_torch.kernels.warp import ops as warp_ops

        if psf_kernels is not None:
            pixels = warp_ops.psf_match(
                pixels[None], torch.zeros(1, dtype=torch.int32, device=pixels.device),
                psf_kernels[None], host_idx=np.zeros(1, np.int32),
            )[0]
        return warp_ops.warp_batch(
            pixels, wcs_vecs, accept.to(torch.float32), grid_ra, grid_dec
        )
    if psf_kernels is not None:
        pixels = psf.convolve_batch(pixels, psf_kernels)
    return project_batch(pixels, wcs_vecs, accept, grid_ra, grid_dec)
