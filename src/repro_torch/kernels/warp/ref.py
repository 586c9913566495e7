"""Plain torch versions of the warp kernels: exactly the mapper's projection.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They repeat the kernels' arithmetic, in the
same operation order, and are no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core import reducer
from repro_torch.core.geometry import sky_to_pixel
from repro_torch.core.mapper import map_batch, project_one

#: Distance (px) from an image edge within which a one-ulp difference in
#: sx or sy may flip the inside test; depth is held exactly everywhere else.
EDGE_TOL = 1e-3


def warp_project_ref(image, wcs_vec, accept, grid_ra, grid_dec):
    """(H,W) image -> (Q,Q) projected tile + coverage."""
    return project_one(image, wcs_vec, accept, grid_ra, grid_dec)


def warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec):
    """(N,H,W) images -> (N,Q,Q) tiles + coverages: the plain map stage."""
    return map_batch(pixels, wcs_vecs, accepts, grid_ra, grid_dec)


def coadd_fused_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec):
    """Map + reduce over (N,H,W) images: sum of projected tiles and coverages."""
    return reducer.reduce_local(*warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec))


def coadd_scan_ref(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec):
    """The whole query scan, plain, on the `coadd_fused` kernel's operands.

    ``pixels`` (P,cap,H,W) and ``wcs_vecs`` (P,cap,8) are the resident
    layout, ``pack_idx`` (G,) the packs to scan and ``accept`` (G,cap) the
    per-slot weights.  As in the reference scan, each pack's partial sum is
    added to the carry in ``pack_idx`` order.  This is also the engine's
    ``use_kernel=False`` pass: map stage then local reduce, per pack.
    """
    q = grid_ra.shape[0]
    coadd = torch.zeros((q, q), dtype=torch.float32, device=pixels.device)
    depth = torch.zeros_like(coadd)
    for g, p in enumerate(pack_idx.tolist()):
        c, d = coadd_fused_ref(pixels[p], wcs_vecs[p], accept[g], grid_ra, grid_dec)
        coadd = coadd + c
        depth = depth + d
    return coadd, depth


def near_edge(height, width, wcs_vecs, accepts, ra, dec, tol=EDGE_TOL):
    """Bool shaped like ``ra``: sky points where some accepted image's plain
    sx or sy lies within ``tol`` px of that image's edge ([0, W-1] x [0, H-1]).

    Only there may two correct versions of the warp disagree on coverage.
    """
    n = wcs_vecs.shape[0]
    lead = (n,) + (1,) * ra.dim()
    sx, sy = sky_to_pixel(ra, dec, wcs_vecs.T.reshape(8, *lead))
    close = (
        (sx.abs() < tol)
        | ((sx - (width - 1.0)).abs() < tol)
        | (sy.abs() < tol)
        | ((sy - (height - 1.0)).abs() < tol)
    )
    return (close & (accepts != 0).reshape(lead)).any(dim=0)


def coverage_flips(cov, cov_plain, height, width, wcs_vecs, accepts, grid_ra, grid_dec,
                   tol=EDGE_TOL):
    """Split the (Q,Q) pixels where two depth maps differ into (near, far).

    ``near`` holds the differing pixels that lie within ``tol`` px of an edge
    of some accepted image (`near_edge`): a one-ulp difference in the trig can
    flip the inside test there.  ``far`` holds every other difference, which
    is a fault.  Both are bool masks shaped like ``cov``.
    """
    diff = cov != cov_plain
    near = torch.zeros_like(diff)
    pts = diff.nonzero(as_tuple=True)
    if len(pts[0]):
        near[pts] = near_edge(height, width, wcs_vecs, accepts,
                              grid_ra[pts], grid_dec[pts], tol)
    return near, diff & ~near
