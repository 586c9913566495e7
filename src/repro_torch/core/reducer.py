"""Reduce stage: accumulate projected tiles into coadd + depth.

Counterpart of ``repro.core.reducer``.  Faithful to Algorithm 3: sum
projected illumination into `coadd` and coverage into `depth`.  The
accumulation is a commutative monoid, which is why the paper could run one
serial reducer per query.

Robust stacks (DESIGN.md §11) are not monoids, but they decompose into
monoidal passes: pass 1 accumulates coverage-weighted moments (S0, S1, S2),
which fix the clip centre and radius (and, for the median, the bounds of a
binapprox histogram, one more pass); the last pass re-scans with centre and
radius as fixed operands and sums only the samples that survive.  Each
function keeps the reference's operation order, so on the same inputs the
two packages agree bit for bit where the sums run in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Reduction variants every executor understands (engine ``reduce=`` values).
REDUCERS = ("mean", "clipped", "median")

# Clip-radius noise guard.  The streaming moments give variance by the
# single-pass form S2/S0 - mu^2, whose float32 cancellation error scales as
# sqrt(eps)*|mu|: on a near-constant stack the computed sigma is noise at
# that scale, and an unguarded k*sigma radius would clip every sample.
# Samples within 1e-3 of the centre are never outliers.
_CLIP_REL = 1e-3
_CLIP_ABS = 1e-12


def reduce_local(tiles: torch.Tensor, covs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serial (per-device) accumulation over the image axis."""
    return tiles.sum(dim=0), covs.sum(dim=0)


def reduce_ordered(tiles: torch.Tensor, covs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`reduce_local` in one fixed order: image 0, then + image 1, + image 2...

    A rejected image adds exact zeros, which leave every partial sum of
    this order unchanged, so the sum does not depend on how many rejected
    images the map covered: a distributed job's sparse map (a shard's gated
    entries) gives the bits of its dense one (the whole slab).  A
    non-finite pixel of a rejected image still spreads its NaN * 0, as in
    `reduce_local`.
    """
    coadd, depth = tiles[0].clone(), covs[0].clone()
    for t, c in zip(tiles[1:], covs[1:]):
        coadd.add_(t)
        depth.add_(c)
    return coadd, depth


def normalize(coadd: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Depth-normalized stack (mean image); zero where depth == 0.

    Exact masking, no epsilon clamp: fractional depths are divided by their
    true weight, never rescaled by a ``max(depth, eps)``.
    """
    covered = depth > 0
    return torch.where(
        covered, coadd / torch.where(covered, depth, torch.ones_like(depth)), 0.0
    )


# ----- robust stacks: monoidal passes (DESIGN.md §11) -----------------------

def _samples(tiles: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Per-image sample values x_i = t_i / c_i (0 where uncovered)."""
    covered = covs > 0
    return torch.where(covered, tiles / torch.where(covered, covs, torch.ones_like(covs)), 0.0)


def moments_local(tiles: torch.Tensor, covs: torch.Tensor):
    """Pass-1 monoid: S0 = Σ c_i, S1 = Σ t_i, S2 = Σ x_i t_i over the image axis."""
    x = _samples(tiles, covs)
    return covs.sum(dim=0), tiles.sum(dim=0), (x * tiles).sum(dim=0)


def clip_stats(s0: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
    """(mean, sigma) per pixel from moment partials; zeros where S0 == 0."""
    pos = s0 > 0
    safe = torch.where(pos, s0, torch.ones_like(s0))
    mu = torch.where(pos, s1 / safe, 0.0)
    var = torch.clamp_min(torch.where(pos, s2 / safe, 0.0) - mu * mu, 0.0)
    return mu, torch.sqrt(var)


def clip_threshold(center: torch.Tensor, sigma: torch.Tensor, k: float) -> torch.Tensor:
    """k-sigma clip radius with the ulp guard (see _CLIP_REL/_CLIP_ABS)."""
    return k * sigma + _CLIP_REL * torch.abs(center) + _CLIP_ABS


def clip_local(tiles: torch.Tensor, covs: torch.Tensor, center: torch.Tensor,
               thresh: torch.Tensor):
    """Final-pass monoid: accumulate only samples inside the clip window.

    The test is the division-free form |t - c*center| <= c*thresh, as in the
    reference and in the ``coadd_clip`` kernel: every path tests the same
    form, so they round the clip decision alike, which the depth parity
    rides on.
    """
    keep = (covs > 0) & (torch.abs(tiles - covs * center) <= covs * thresh)
    return torch.where(keep, tiles, 0.0).sum(dim=0), torch.where(keep, covs, 0.0).sum(dim=0)


def hist_bounds(s0: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, nbins: int):
    """Binapprox bin bounds (lo, w, inv_w) from the moments.

    lo = mu - sigma, w = 2 sigma / nbins (the median lies within sigma of
    the mean).  Only the reciprocal is clamped, so a sigma = 0 stack keeps a
    true zero width and reports med = lo = mu exactly.
    """
    mu, sigma = clip_stats(s0, s1, s2)
    w = (2.0 * sigma) / nbins
    return mu - sigma, w, torch.reciprocal(torch.clamp_min(w, 1e-30))


def hist_local(tiles: torch.Tensor, covs: torch.Tensor, lo: torch.Tensor,
               inv_w: torch.Tensor, nbins: int) -> torch.Tensor:
    """Median round-1 monoid: (nbins, H, W) coverage-weighted histogram.

    One compare-select-sum per bin, as the reference computes it (its scan
    over bins only tunes XLA's memory use).  The bin index stays a float, as
    in the ``coadd_hist`` kernels: every finite index matches the
    reference's, and a NaN sample lands in no bin.
    """
    x = _samples(tiles, covs)
    b = torch.clamp(torch.floor((x - lo) * inv_w), 0, nbins - 1)
    cw = torch.where(covs > 0, covs, 0.0)
    return torch.stack([torch.where(b == j, cw, 0.0).sum(dim=0) for j in range(nbins)])


def hist_median(hist: torch.Tensor, s0: torch.Tensor, lo: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Approximate weighted median: first bin whose cumsum crosses S0/2.

    The bins are the third axis from the end, so a batch's (K, nbins, Q, Q)
    histograms take their (K, Q, Q) ``s0``, ``lo`` and ``w`` as one query's
    (nbins, Q, Q) takes its (Q, Q) ones, query by query the same bits.
    """
    c = torch.cumsum(hist, dim=-3)
    j = (c >= 0.5 * s0.unsqueeze(-3)).to(torch.uint8).argmax(dim=-3).to(hist.dtype)
    return lo + (j + 0.5) * w


def robust_local(tiles: torch.Tensor, covs: torch.Tensor, reduce: str = "clipped",
                 clip_k: float = 3.0, median_bins: int = 16):
    """Single-shot robust stack of an in-memory (N, H, W) sample stack.

    The eager composition of the passes: moments -> (binapprox histogram for
    "median") -> clip re-scan, with the passes' own operand math.
    """
    s0, s1, s2 = moments_local(tiles, covs)
    mu, sigma = clip_stats(s0, s1, s2)
    if reduce == "median":
        lo, w, inv_w = hist_bounds(s0, s1, s2, median_bins)
        center = hist_median(hist_local(tiles, covs, lo, inv_w, median_bins), s0, lo, w)
    elif reduce == "clipped":
        center = mu
    else:
        raise ValueError(f"robust_local: unknown reduce {reduce!r}")
    return clip_local(tiles, covs, center, clip_threshold(center, sigma, clip_k))


# ----- brick mosaic (DESIGN.md §9) ------------------------------------------

def mosaic_tiles(tiles: torch.Tensor, covs: torch.Tensor, offsets: torch.Tensor,
                 npix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-sum merge of brick tiles into an (npix, npix) mosaic.

    ``tiles``/``covs`` are (B, bh, bw) cached brick coadds + weight maps,
    ``offsets`` (B, 2) int32 (row, col) canvas positions.  A zero canvas
    accumulates ``canvas[r:r+bh, c:c+bw] += tile`` in brick order, so
    overlapping tiles sum in that order.  Each offset is placed as the
    reference's ``dynamic_slice`` (and its Pallas kernel) places it: a
    negative one counts once from the end (``r + npix``), then it is clamped
    to ``[0, npix - bh]`` (``[0, npix - bw]`` for the column).  The plain
    version of the ``mosaic_bricks`` kernel, which gives the same bits.
    """
    _, bh, bw = tiles.shape
    if bh > npix or bw > npix:
        raise ValueError(f"tiles ({bh}, {bw}) do not fit an ({npix}, {npix}) canvas")
    coadd = torch.zeros((npix, npix), dtype=tiles.dtype, device=tiles.device)
    depth = torch.zeros((npix, npix), dtype=covs.dtype, device=covs.device)
    for b, (r, c) in enumerate(offsets.tolist()):
        r = min(max(r + npix if r < 0 else r, 0), npix - bh)
        c = min(max(c + npix if c < 0 else c, 0), npix - bw)
        coadd[r:r + bh, c:c + bw] += tiles[b]
        depth[r:r + bh, c:c + bw] += covs[b]
    return coadd, depth


# ----- collective reduction over a device mesh (DESIGN.md §4) ---------------

def reduce_collective(local_coadd: torch.Tensor, local_depth: torch.Tensor, mesh,
                      axis_name=("data",), scatter_axis_name: Optional[str] = "model"):
    """Cross-rank reduction of per-rank partial coadds over a `DeviceMesh`.

    Counterpart of the reference's ``reduce_collective`` under
    ``shard_map``; every rank of ``mesh`` calls it with partials of one
    shape, (..., npix, npix) (the engine's (nq, npix, npix) stack).  First
    an ``all_reduce`` SUM over each data axis's group in turn, as the
    reference psums one axis at a time; then, with a model axis, a
    reduce-scatter of the output ROWS over the model group, so model shard
    i owns rows [i * npix / m, (i + 1) * npix / m) of every image in the
    stack (the reference vmaps its reduction over queries: each query gets
    its own band).  Coadd and depth travel in one buffer.  -> (coadd, depth)
    fully reduced, or this rank's (..., npix / m, npix) bands of them
    (`gather_collective` rebuilds the full arrays).
    """
    import torch.distributed as dist

    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    buf = torch.stack([local_coadd, local_depth])
    for ax in axes:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.get_group(ax))
    if scatter_axis_name is None:
        return buf[0], buf[1]
    group = mesh.get_group(scatter_axis_name)
    m = dist.get_world_size(group)
    npix = buf.shape[-2]
    if npix % m:
        raise ValueError(f"npix={npix} must divide by the model axis {m}")
    # reduce_scatter_tensor splits dim 0: move the rows there first (dim 0
    # of the stack is coadd/depth, dim 1 the query).
    rows = buf.movedim(-2, 0).contiguous()
    band = torch.empty((npix // m,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=rows.device)
    dist.reduce_scatter_tensor(band, rows, op=dist.ReduceOp.SUM, group=group)
    band = band.movedim(0, -2)
    return band[0], band[1]


def gather_collective(coadd_band: torch.Tensor, depth_band: torch.Tensor, mesh,
                      scatter_axis_name: Optional[str] = "model"):
    """Every rank's full (..., npix, npix) arrays from the model shards' row
    bands (`reduce_collective`): an all-gather over the model group, rows
    in shard order.  Without a model axis the arrays are already whole."""
    import torch.distributed as dist

    if scatter_axis_name is None:
        return coadd_band, depth_band
    group = mesh.get_group(scatter_axis_name)
    m = dist.get_world_size(group)
    rows = torch.stack([coadd_band, depth_band]).movedim(-2, 0).contiguous()
    full = torch.empty((rows.shape[0] * m,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=rows.device)
    dist.all_gather_into_tensor(full, rows, group=group)
    full = full.movedim(0, -2)
    return full[0], full[1]
