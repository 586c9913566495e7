"""Plain torch versions of the warp and PSF-matching kernels: exactly the
mapper's projection, after `psf.convolve_batch` where a bank is given.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They repeat the kernels' arithmetic, in the
same operation order, and are no yardstick of speed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import psf, reducer
from repro_torch.core.geometry import make_grid_wcs, pixel_to_sky, sky_to_pixel, tangent_to_sky
from repro_torch.core.mapper import map_batch, project_batch, project_one

#: Distance (px) from an image edge within which a one-ulp difference in
#: sx or sy may flip the inside test; depth is held exactly everywhere else.
EDGE_TOL = 1e-3
#: Relative distance from a clip or bin boundary within which a sample's
#: decision may flip between two correct versions: their samples differ by
#: a few ulps, and across pack layouts the sums S1, S2 (and so the centre,
#: radius and bins) differ by rounding.
DECISION_TOL = 1e-4


def warp_project_ref(image, wcs_vec, accept, grid_ra, grid_dec):
    """(H,W) image -> (Q,Q) projected tile + coverage."""
    return project_one(image, wcs_vec, accept, grid_ra, grid_dec)


def warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec):
    """(N,H,W) images -> (N,Q,Q) tiles + coverages: the plain map stage."""
    return map_batch(pixels, wcs_vecs, accepts, grid_ra, grid_dec)


def coadd_fused_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec):
    """Map + reduce over (N,H,W) images: sum of projected tiles and coverages."""
    return reducer.reduce_local(*warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec))


def coadd_moments_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec):
    """Robust pass 1 over (N,H,W) images -> (S0, S1, S2).

    With accept and coverage both 0 or 1, as on this path, the reducer's
    S2 term x*t = (t/c)*t and the kernel's per-sample vm*vm/m (times a)
    are the same float operations, so the two forms give the same bits.
    """
    return reducer.moments_local(*warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec))


def coadd_hist_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec, lo, inv_w, nbins):
    """Median round 1 over (N,H,W) images -> (nbins,Q,Q) histogram."""
    tiles, covs = warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec)
    return reducer.hist_local(tiles, covs, lo, inv_w, nbins)


def coadd_clip_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec, center, thresh):
    """Robust final pass over (N,H,W) images -> (coadd, depth) of kept samples."""
    tiles, covs = warp_batch_ref(pixels, wcs_vecs, accepts, grid_ra, grid_dec)
    return reducer.clip_local(tiles, covs, center, thresh)


def psf_match_ref(pixels, pack_idx, bank, skip=None):
    """The ``psf_match`` kernels' plain version -> (G,cap,H,W) matched frames.

    The packs ``pack_idx`` of the resident (P,cap,H,W) ``pixels``, each
    frame correlated with its slot's kernel of the (P,cap,K) or
    (P,cap,Kh,Kw) ``bank`` (`psf.convolve_batch`).  Frames whose (G,cap)
    ``skip`` flag is set are zeros, and only the others are matched; None
    matches every frame.
    """
    rows = pack_idx.to(torch.int64)
    g = rows.shape[0]
    cap, h, w = pixels.shape[1:]
    images = pixels[rows].reshape(g * cap, h, w)
    kernels = bank[rows].reshape((g * cap,) + tuple(bank.shape[2:]))
    if skip is None:
        return psf.convolve_batch(images, kernels).reshape(g, cap, h, w)
    keep = (skip == 0).reshape(-1)
    out = torch.zeros_like(images)
    if bool(keep.any()):
        out[keep] = psf.convolve_batch(images[keep], kernels[keep])
    return out.reshape(g, cap, h, w)


def mosaic_bricks_ref(tiles, covs, offsets, npix):
    """The ``mosaic_bricks`` kernel's plain version -> (npix,npix) coadd, depth.

    (B,bh,bw) tiles and weight maps added into zero canvases at their
    (B,2) int32 offsets, placed as the reference places them, in brick
    order (`reducer.mosaic_tiles`).
    """
    return reducer.mosaic_tiles(tiles, covs, offsets, npix)


def _scan(local, pixels, wcs_vecs, pack_idx, accept, psf_kernels=None):
    """Sum ``local(pack pixels, pack wcs, pack accept)`` over the packs.

    ``pixels`` (P,cap,H,W) and ``wcs_vecs`` (P,cap,8) are the resident
    layout, ``pack_idx`` (G,) the packs to scan and ``accept`` (G,cap) the
    per-slot weights.  As in the reference scan, each pack's partial sums
    are added to the zero-initialised carry in ``pack_idx`` order.  With a
    ``psf_kernels`` bank each pack's frames are PSF-matched first
    (`psf.convolve_batch`, the same operations as `psf_match_ref`).
    """
    out = None
    for g, p in enumerate(pack_idx.tolist()):
        px = pixels[p] if psf_kernels is None else psf.convolve_batch(pixels[p], psf_kernels[p])
        part = local(px, wcs_vecs[p], accept[g])
        if out is None:
            out = [torch.zeros_like(t) for t in part]
        out = [o + t for o, t in zip(out, part)]
    return tuple(out)


def coadd_scan_ref(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, psf_kernels=None):
    """The whole query scan, plain, on the `coadd_fused` kernel's operands.

    This is also the engine's ``use_kernel=False`` mean pass: map stage then
    local reduce, per pack.
    """
    return _scan(lambda px, wv, a: coadd_fused_ref(px, wv, a, grid_ra, grid_dec),
                 pixels, wcs_vecs, pack_idx, accept, psf_kernels)


def moments_scan_ref(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, psf_kernels=None):
    """The moments pass, plain, on the `coadd_moments` kernel's operands."""
    return _scan(lambda px, wv, a: coadd_moments_ref(px, wv, a, grid_ra, grid_dec),
                 pixels, wcs_vecs, pack_idx, accept, psf_kernels)


def hist_scan_ref(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, lo, inv_w, nbins,
                  psf_kernels=None):
    """The histogram pass, plain, on the `coadd_hist` kernel's operands."""
    (hist,) = _scan(
        lambda px, wv, a: (coadd_hist_ref(px, wv, a, grid_ra, grid_dec, lo, inv_w, nbins),),
        pixels, wcs_vecs, pack_idx, accept, psf_kernels)
    return hist


def clip_scan_ref(pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, center, thresh,
                  psf_kernels=None):
    """The clip pass, plain, on the `coadd_clip` kernel's operands."""
    return _scan(lambda px, wv, a: coadd_clip_ref(px, wv, a, grid_ra, grid_dec, center, thresh),
                 pixels, wcs_vecs, pack_idx, accept, psf_kernels)


def _per_query(scan_ref, pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec, *fixed,
               **kw):
    """A one-query scan's plain version over K queries: query k on its own
    (G,cap) accept, (Q,Q) grids and fixed operands, stacked along K."""
    outs = [scan_ref(pixels, wcs_vecs, pack_idx, accepts[k], grids_ra[k], grids_dec[k],
                     *(f[k] for f in fixed), **kw) for k in range(accepts.shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(parts) for parts in zip(*outs))


def coadd_scan_batch_ref(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                         psf_kernels=None):
    """`coadd_fused_batch`'s plain version: `coadd_scan_ref` per query."""
    return _per_query(coadd_scan_ref, pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                      psf_kernels=psf_kernels)


def moments_scan_batch_ref(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                           psf_kernels=None):
    """`coadd_moments_batch`'s plain version: `moments_scan_ref` per query."""
    return _per_query(moments_scan_ref, pixels, wcs_vecs, pack_idx, accepts, grids_ra,
                      grids_dec, psf_kernels=psf_kernels)


def hist_scan_batch_ref(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec, los, inv_ws,
                        nbins, psf_kernels=None):
    """`coadd_hist_batch`'s plain version: `hist_scan_ref` per query."""
    return _per_query(hist_scan_ref, pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                      los, inv_ws, nbins=nbins, psf_kernels=psf_kernels)


def clip_scan_batch_ref(pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec, centers,
                        threshs, psf_kernels=None):
    """`coadd_clip_batch`'s plain version: `clip_scan_ref` per query."""
    return _per_query(clip_scan_ref, pixels, wcs_vecs, pack_idx, accepts, grids_ra, grids_dec,
                      centers, threshs, psf_kernels=psf_kernels)


# The culled pack scan's footprint test (csrc/warp.cu, `misses_tile`): the
# block tile, its four 8 x 8 sub-tiles, and the constants of its bound.
TILE_X, TILE_Y, SUB_W = 32, 8, 8
MAX_CHORD, SKY_ERR, MIN_COS_FAR = 0.05, 4e-6, 0.05


def _sub_tiles(grid_ra, grid_dec):
    """Per sub-tile of each block tile -> (ra_r, sin_dec, cos_dec, r, state),
    each (ny, nx, 4): its centre pixel, padded cap radius and state (0 no
    live pixel, 1 cullable, 2 never culled), as ``tile_caps`` computes them."""
    q = grid_ra.shape[0]
    dev = grid_ra.device
    ny, nx = -(-q // TILE_Y), -(-q // TILE_X)
    ra_r, dec_r = grid_ra * (torch.pi / 180.0), grid_dec * (torch.pi / 180.0)
    sd, cd = torch.sin(dec_r), torch.cos(dec_r)
    unit = torch.stack([cd * torch.cos(ra_r), cd * torch.sin(ra_r), sd], -1)   # (Q,Q,3)
    col0 = (torch.arange(nx, device=dev)[:, None] * TILE_X
            + torch.arange(4, device=dev)[None, :] * SUB_W)                      # (nx,4)
    cols = (col0 + SUB_W // 2 - 1).clamp(max=q - 1)
    rows = (torch.arange(ny, device=dev) * TILE_Y + TILE_Y // 2 - 1).clamp(max=q - 1)
    cen = unit[rows[:, None, None], cols[None]]                                   # (ny,nx,4,3)
    # Each pixel's chord to its sub-tile's centre; dead pixels (past q) add 0.
    pad = torch.zeros((ny * TILE_Y, nx * TILE_X, 3), device=dev)
    pad[:q, :q] = unit
    live = torch.zeros((ny * TILE_Y, nx * TILE_X), dtype=torch.bool, device=dev)
    live[:q, :q] = True
    blocks = pad.reshape(ny, TILE_Y, nx, 4, SUB_W, 3)
    live = live.reshape(ny, TILE_Y, nx, 4, SUB_W)
    chord = (blocks - cen[:, None, :, :, None]).square().sum(-1).sqrt()
    chord = torch.where(live & ~(chord <= MAX_CHORD), 1.0, torch.where(live, chord, 0.0))
    chord = chord.amax(dim=(1, 4))                                                # (ny,nx,4)
    state = torch.where(col0[None] < q, torch.where(chord <= MAX_CHORD, 1, 2), 0)
    r = chord * 1.01 + SKY_ERR
    pick = (rows[:, None, None], cols[None])
    return ra_r[pick], sd[pick], cd[pick], r, state


def footprint_keep(wcs_vecs, accept, finite, grid_ra, grid_dec, height, width):
    """The culled pack scan's staging decision, plain: (ny, nx, S) bool, True
    where the block tile (by, bx) samples slot s of the flat (S, 8)
    ``wcs_vecs`` with (S,) ``accept`` and (S,) bool ``finite`` flag (or None).

    A slot is skipped when it is rejected and flagged, or when its accept is
    finite and every live sub-tile's padded box misses the frame (the bound
    in the header of csrc/warp.cu).  Float32 like the kernel, but torch's
    trig may round differently: tests and ``chip_smoke.py`` use it to count
    and to check the bound, never in place of the kernel.
    """
    sra, ssd, scd, r, state = (t[..., None] for t in _sub_tiles(grid_ra, grid_dec))
    cos_r, sin_r = torch.cos(r), torch.sin(r)
    k2r = torch.pi / 180.0
    v = wcs_vecs.T.reshape(8, 1, 1, 1, -1)
    ra0_r, dec0_r = v[0] * k2r, v[1] * k2r
    sin0, cos0 = torch.sin(dec0_r), torch.cos(dec0_r)
    cd11, cd12, cd21, cd22 = v[4], v[5], v[6], v[7]
    det = cd11 * cd22 - cd12 * cd21
    dra = sra - ra0_r
    cosc = sin0 * ssd + cos0 * scd * torch.cos(dra)
    xi = scd * torch.sin(dra) / cosc * (180.0 / torch.pi)
    eta = (cos0 * ssd - sin0 * scd * torch.cos(dra)) / cosc * (180.0 / torch.pi)
    sx = (cd22 * xi - cd12 * eta) / det + v[2]
    sy = (-cd21 * xi + cd11 * eta) / det + v[3]
    sin_c = (1.0 - cosc * cosc).clamp(min=0.0).sqrt()
    cos_far = cosc * cos_r - sin_c * sin_r
    lx = (cd22.abs() + cd12.abs()) / det.abs() * (180.0 / torch.pi)
    ly = (cd21.abs() + cd11.abs()) / det.abs() * (180.0 / torch.pi)
    stretch = 1.01 * r / (cos_far * cos_far)
    slack = 1.0 + 2e-5 * (sx.abs() + sy.abs())
    ex, ey = stretch * lx + slack, stretch * ly + slack
    hit = (sx + ex >= 0) & (sx - ex <= width - 1) & (sy + ey >= 0) & (sy - ey <= height - 1)
    bounded = (cos_far > MIN_COS_FAR) & (sx.abs() < 1e30) & (sy.abs() < 1e30)
    keep_sub = (state == 2) | ((state == 1) & (~bounded | hit))
    misses = ~keep_sub.any(dim=2) & ((lx < float("inf")) & (ly < float("inf"))).reshape(-1)
    culled = misses & (accept.abs() < float("inf"))
    if finite is not None:
        culled |= (accept == 0) & finite
    return ~culled


def scattered_frames(center_ra, center_dec, npix, fov_deg, n, height, width, seed):
    """A synthetic sky anywhere on the sphere, for the footprint test where
    the survey's own patch does not reach (high |dec|, RA 0/360): the
    (npix, npix) float32 sky of a TAN grid centred at (center_ra,
    center_dec), and (n, 8) float32 WCS vectors of (height, width) frames
    scattered over the grid and just past its edges, rotated and flipped at
    random, at 0.5-2x the grid's scale.  Every RA, the grid's and the
    frames' reference, is wrapped into [0, 360), so a grid about RA 0 holds
    both 359.9x and 0.0x.  -> (grid_ra, grid_dec, wcs) numpy."""
    g = make_grid_wcs(center_ra, center_dec, npix, fov_deg).to_vector().astype(np.float64)
    xs, ys = np.meshgrid(np.arange(npix, dtype=np.float64), np.arange(npix, dtype=np.float64))
    ra, dec = pixel_to_sky(xs, ys, g)
    rng = np.random.default_rng(seed)
    xi, eta = rng.uniform(-0.65 * fov_deg, 0.65 * fov_deg, (2, n))
    ra0, dec0 = tangent_to_sky(xi, eta, center_ra, center_dec)
    scale = fov_deg / npix * rng.uniform(0.5, 2.0, n)
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    flip = rng.choice([-1.0, 1.0], n)
    cd = np.stack([scale * flip * np.cos(theta), -scale * np.sin(theta),
                   scale * flip * np.sin(theta), scale * np.cos(theta)], 1)
    crpix = np.stack([rng.uniform(0.0, width - 1.0, n), rng.uniform(0.0, height - 1.0, n)], 1)
    wcs = np.concatenate([np.stack([ra0 % 360.0, dec0], 1), crpix, cd], 1)
    return ((ra % 360.0).astype(np.float32), dec.astype(np.float32), wcs.astype(np.float32))


def staging_scans(n_queries=3, seed=0):
    """Scans shaped for the culled pack scan's staging (csrc/warp.cu): name ->
    (pixels (P, cap, H, W), wcs (P, cap, 8), pack_idx (G,) int32, accepts
    (K, G, cap), grids_ra (K, Q, Q), grids_dec, flag) numpy, ``flag`` True
    where the scan takes the layout's finite flag (`seqfile.finite_slots`),
    False where it takes None.  Frames of 16 x 24 px over a
    `scattered_frames` sky; K = ``n_queries``, query k's grid the first moved
    by 0.05 k deg in RA, its accepts random in {0, 0.5, 1}.

    ``cap300``: a pack spans two 256-slot rounds.  ``cap1``, ``cap33``.
    ``sparse_repeated``: three padding rows repeating pack 0, accepts 0.
    ``all_rejected``: every slot rejected and flagged.  ``no_flag``: every
    slot a candidate.  ``wide_cap``: 0.625 deg pixels, so no sub-tile is
    narrow enough to cull (state 2) and a block keeps most of 12 packs x 33
    slots.  ``poisoned``: the three rejected slots that cover the first
    grid most hold NaN, inf and 2**70 frames (their flag clear)."""
    h, w = 16, 24
    rng = np.random.default_rng(seed)
    # name: (packs, cap, pack_idx, npix, fov_deg, share of slots accepted)
    shapes = {
        "cap300": (2, 300, [1, 0], 70, 0.5, 0.7),
        "cap1": (40, 1, list(rng.permutation(40)), 70, 0.5, 0.7),
        "cap33": (9, 33, list(range(9)), 70, 0.5, 0.7),
        "sparse_repeated": (6, 16, [4, 1, 3, 0, 0, 0], 70, 0.5, 0.7),
        "all_rejected": (4, 64, [0, 1, 2, 3], 70, 0.5, 0.0),
        "no_flag": (4, 64, [0, 1, 2, 3], 70, 0.5, 0.7),
        "wide_cap": (12, 33, list(range(12)), 64, 40.0, 0.9),
        "poisoned": (2, 64, [0, 1], 70, 0.5, 0.7),
    }
    out = {}
    for i, (name, (n_packs, cap, idx, npix, fov, share)) in enumerate(shapes.items()):
        gra, gdec, wcs = scattered_frames(20.0, 30.0, npix, fov, n_packs * cap, h, w, seed + i)
        pixels = rng.normal(100.0, 10.0, (n_packs, cap, h, w)).astype(np.float32)
        g = len(idx)
        accepts = ((rng.random((n_queries, g, cap)) < share)
                   * rng.choice(np.float32([0.5, 1.0]), (n_queries, g, cap))).astype(np.float32)
        if name == "sparse_repeated":
            accepts[:, 3:] = 0.0
        if name == "poisoned":
            sx, sy = sky_to_pixel(torch.from_numpy(gra), torch.from_numpy(gdec),
                                  torch.from_numpy(wcs).T.reshape(8, -1, 1, 1))
            cover = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)).sum((1, 2))
            for value, slot in zip((np.nan, np.inf, np.float32(2.0 ** 70)),
                                   cover.argsort(descending=True)[:3].tolist()):
                pixels.reshape(-1, h, w)[slot] = value
                accepts[:, idx.index(slot // cap), slot % cap] = 0.0
        moved = [(gra + np.float32(0.05 * k)) % np.float32(360.0) for k in range(n_queries)]
        out[name] = (pixels, wcs.reshape(n_packs, cap, 8), np.asarray(idx, np.int32), accepts,
                     np.stack(moved), np.stack([gdec] * n_queries), name != "no_flag")
    return out


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


def decision_flips(diff, pixels, wcs_vecs, pack_idx, accept, grid_ra, grid_dec, *,
                   clip=None, bins=None, tol=DECISION_TOL):
    """Split the differing (Q,Q) pixels ``diff`` of two robust passes into (near, far).

    Takes the kernels' scan operands.  A differing pixel is ``near`` when some
    accepted sample there lies within ``EDGE_TOL`` px of its image's edge
    (`near_edge`), or, given ``clip=(center, thresh)``, within ``tol`` of the
    clip boundary: ||t - c*center| - c*thresh| <= tol*(|t| + c*|center| +
    c*thresh); or, given ``bins=(lo, w, inv_w, nbins)``, within ``tol`` of an
    inner bin edge: |u - k|*w <= tol*(|x| + |lo| + w) for u = (x - lo)*inv_w
    and the integer k in [1, nbins-1] nearest u (every sample is near when
    w == 0).  Only there may two correct versions decide differently;
    ``far`` holds every other difference, which is a fault.
    """
    near = torch.zeros_like(diff)
    pts = diff.nonzero(as_tuple=True)
    if not len(pts[0]):
        return near, diff
    h, w = pixels.shape[-2:]
    ra, dec = grid_ra[pts], grid_dec[pts]
    close = torch.zeros_like(ra, dtype=torch.bool)
    for g, p in enumerate(pack_idx.tolist()):
        close |= near_edge(h, w, wcs_vecs[p], accept[g], ra, dec)
        t, c = project_batch(pixels[p], wcs_vecs[p], accept[g], ra, dec)
        if clip is not None:
            center, thresh = (v[pts] for v in clip)
            gap = (t - c * center).abs() - c * thresh
            scale = t.abs() + c * center.abs() + c * thresh
            close |= ((c > 0) & (gap.abs() <= tol * scale)).any(dim=0)
        if bins is not None:
            lo, bw, inv_w = (v[pts] for v in bins[:3])
            x = reducer._samples(t, c)
            u = (x - lo) * inv_w
            k = u.round().clamp(1, bins[3] - 1)
            edge = ((u - k).abs() * bw <= tol * (x.abs() + lo.abs() + bw)) | (bw == 0)
            close |= ((c > 0) & edge).any(dim=0)
    near[pts] = close
    return near, diff & ~near
