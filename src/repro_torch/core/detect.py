"""Difference imaging + source detection (DESIGN.md §11).

Counterpart of ``repro.core.detect``.  The paper's motivating workload is
nightly transient detection: coaddition is the preprocessing step whose
product, a deep PSF-homogenized template, new epochs are differenced
against, and the materialized brick coadds (DESIGN.md §9) are that
template.

* ``inject_transients`` — seeded synthetic transients splatted into one
  epoch of a survey on the host, before any engine sees the pixels (numpy,
  bitwise the reference's).
* ``difference_image`` — new-epoch stack minus the brick-served template,
  both depth-normalized, through the port's engine.
* ``detect_sources`` — thresholded detection in plain torch on the engine's
  device: per-pixel noise scaling from the two depth maps, a robust MAD
  noise floor, 3x3 local-maximum peaks and a top-K extraction of
  (x, y, flux, npix, snr) rows.  The reference computes it in XLA outside
  any Pallas kernel, so plain torch is its form here.
* ``match_detections`` — grades a catalog against the injected truths.

Detection is *relative*: the difference is scored in units of its own
robust noise, so the drill needs no knowledge of the survey's noise level.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.geometry import sky_to_pixel
from repro_torch.core.query import CoaddQuery
from repro_torch.core.survey import Survey


@dataclasses.dataclass
class DetectionCatalog:
    """Thresholded detections from one difference image (host arrays)."""

    x: np.ndarray       # (n,) int32 column of each peak on the output grid
    y: np.ndarray       # (n,) int32 row
    flux: np.ndarray    # (n,) float32 3x3 aperture sum of the difference
    npix: np.ndarray    # (n,) int32 above-threshold pixels in the 3x3 box
    snr: np.ndarray     # (n,) float32 peak significance in MAD-sigma units

    def __len__(self) -> int:
        return int(self.x.shape[0])


def epoch_time_bounds(survey: Survey, run: Optional[int] = None) -> Tuple[float, float]:
    """The ``time_bounds`` window selecting exactly one run (epoch).

    The synthetic survey stamps ``t_obs = run * 100 + field``; the default
    is the final run, the "tonight" epoch a nightly pipeline differences.
    """
    if run is None:
        run = survey.config.n_runs - 1
    return (float(run * 100), float(run * 100 + 99))


def inject_transients(
    survey: Survey,
    query: CoaddQuery,
    n: int = 8,
    flux: float = 400.0,
    run: Optional[int] = None,
    seed: int = 7,
    margin_frac: float = 0.12,
    min_sep_px: float = 6.0,
) -> np.ndarray:
    """Splat ``n`` seeded point transients into one epoch of ``survey``.

    Positions are drawn uniformly inside the query box (shrunk by
    ``margin_frac``), rejection-sampled to pairwise separations of at least
    ``min_sep_px`` grid pixels; each transient is a Gaussian of total
    ``flux`` at the image's own seeing, added to every covering frame of
    the chosen run and band, in place, before any engine ingests the
    survey.  Returns the (n, 2) array of (ra, dec) truths.
    """
    if run is None:
        run = survey.config.n_runs - 1
    rng = np.random.default_rng(seed)
    ra0, ra1 = query.ra_bounds
    dec0, dec1 = query.dec_bounds
    mra, mdec = margin_frac * (ra1 - ra0), margin_frac * (dec1 - dec0)
    ras_l: List[float] = []
    decs_l: List[float] = []
    gx: List[float] = []
    gy: List[float] = []
    for _ in range(10000):
        if len(ras_l) >= n:
            break
        ra = rng.uniform(ra0 + mra, ra1 - mra)
        dec = rng.uniform(dec0 + mdec, dec1 - mdec)
        x, y = sky_to_grid(query, np.array([ra]), np.array([dec]))
        if any((x[0] - a) ** 2 + (y[0] - b) ** 2 < min_sep_px ** 2 for a, b in zip(gx, gy)):
            continue
        ras_l.append(ra)
        decs_l.append(dec)
        gx.append(float(x[0]))
        gy.append(float(y[0]))
    if len(ras_l) < n:
        raise ValueError(f"could not place {n} transients {min_sep_px}px apart")
    ras, decs = np.array(ras_l), np.array(decs_l)
    for im in survey.images:
        if im.run != run or im.band != query.band:
            continue
        h, w = im.pixels.shape
        v = im.wcs.to_vector().astype(np.float64)
        px, py = sky_to_pixel(ras, decs, v)
        ys, xs = np.mgrid[0:h, 0:w]
        for cx, cy in zip(px, py):
            if not (-1 < cx < w and -1 < cy < h):
                continue
            s = float(im.psf_sigma)
            prof = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * s * s)) / (
                2.0 * np.pi * s * s)
            im.pixels += (flux * prof).astype(im.pixels.dtype)
    return np.stack([ras, decs], axis=1)


def difference_image(
    engine,
    query: CoaddQuery,
    run: Optional[int] = None,
    method: str = "sql_structured",
    reduce: str = "mean",
    use_bricks: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """New-epoch stack minus the all-epoch template, depth-normalized.

    The template is served from the materialized brick coadds when the
    query decomposes (``use_bricks``); the epoch is a time-bounded query
    through the same engine, so both sides share the PSF-matching bank.
    Returns ``(diff, depth_epoch, depth_template)`` as host float arrays.

    A time-bounded query never decomposes, so for a brick-aligned query the
    epoch runs on the query's own TAN grid while the template sits on the
    brick lattice; the two grids differ by a fraction of a pixel (the
    reference's behaviour, kept).
    """
    bounds = epoch_time_bounds(engine.survey, run)
    epoch_q = dataclasses.replace(query, time_bounds=bounds)
    template = engine.run(query, method, use_bricks=use_bricks, reduce=reduce)
    epoch = engine.run(epoch_q, method, reduce=reduce)
    diff = epoch.normalized - template.normalized
    return diff, epoch.depth, template.depth


def _nanmedian(a: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a whole tensor, as a 0-d tensor.

    The mean of the two middle valid values for an even count (numpy's
    midpoint rule; ``torch.nanmedian`` returns the lower one), computed
    ``(lo + hi) * 0.5`` in float32 as the reference does.  A full sort
    (NaNs sort last) rather than ``torch.nanquantile``, whose input is
    capped at 2**24 elements; no host sync.  All-NaN gives NaN.
    """
    v = a.reshape(-1)
    s = torch.sort(v).values
    n = (~torch.isnan(v)).sum()
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = n // 2
    return (s[lo] + s[hi]) * 0.5


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum with zero padding outside the canvas ("SAME"), in
    row-major tap order."""
    p = F.pad(x[None, None], (1, 1, 1, 1))[0, 0]
    h, w = x.shape
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


def _detect(diff, depth_a, depth_b, nsigma: float, max_sources: int):
    """Detection on (Q, Q) device tensors -> (x, y, flux, npix, snr, count)."""
    q = diff.shape[0]
    valid = (depth_a > 0) & (depth_b > 0)
    one = torch.ones_like(depth_a)
    # Per-pixel noise of a difference of two depth-normalized stacks scales
    # as sqrt(1/Na + 1/Nb); the MAD floor calibrates away the absolute level.
    scale = torch.sqrt(1.0 / torch.where(valid, depth_a, one)
                       + 1.0 / torch.where(valid, depth_b, one))
    r = torch.where(valid, diff / scale, torch.nan)
    med = _nanmedian(r)
    sigma1 = 1.4826 * _nanmedian(torch.abs(r - med)) + 1e-12
    snr = torch.where(valid, (r - med) / sigma1, 0.0)
    # 3x3 maximum with -inf outside the canvas, as the reference's
    # reduce_window "SAME" pads it.
    neigh_max = F.max_pool2d(snr[None, None], 3, stride=1, padding=1)[0, 0]
    above = (snr >= nsigma) & valid
    peaks = above & (snr >= neigh_max)
    box_flux = _box3(torch.where(valid, diff, 0.0))
    box_npix = _box3(above.to(torch.int32))
    score = torch.where(peaks, snr, -torch.inf).reshape(-1)
    # jax.lax.top_k breaks ties toward the lower index: a stable sort.
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:max_sources], idx[:max_sources]
    count = torch.clamp(peaks.sum(), max=max_sources)
    return (
        (idx % q).to(torch.int32),
        (idx // q).to(torch.int32),
        box_flux.reshape(-1)[idx],
        box_npix.reshape(-1)[idx],
        top,
        count,
    )


def detect_sources(
    diff: np.ndarray,
    depth_epoch: np.ndarray,
    depth_template: np.ndarray,
    nsigma: float = 5.0,
    max_sources: int = 32,
    device="cuda",
) -> DetectionCatalog:
    """Thresholded detection on a difference image, on ``device``.

    A pixel is a detection seed when its depth-scaled, MAD-normalized
    significance reaches ``nsigma`` AND it is the maximum of its 3x3
    neighbourhood (one catalog row per source, not per bright pixel).  The
    rows are the ``max_sources`` highest significances, ties to the lower
    flat index; rows beyond the true count are dropped.
    """
    dev = torch.device(device)
    x, y, flux, npix, snr, count = _detect(
        *(torch.from_numpy(np.array(a, np.float32)).to(dev)
          for a in (diff, depth_epoch, depth_template)),
        float(nsigma), int(max_sources))
    k = int(count)
    return DetectionCatalog(
        x=x[:k].cpu().numpy(),
        y=y[:k].cpu().numpy(),
        flux=flux[:k].cpu().numpy(),
        npix=npix[:k].cpu().numpy(),
        snr=snr[:k].cpu().numpy(),
    )


def sky_to_grid(query: CoaddQuery, ra: np.ndarray, dec: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(ra, dec) -> fractional (x, y) on the query's output grid."""
    g = query.grid_wcs_vector().astype(np.float64)
    return sky_to_pixel(np.asarray(ra, np.float64), np.asarray(dec, np.float64), g)


def match_detections(
    catalog: DetectionCatalog,
    query: CoaddQuery,
    truth_radec: np.ndarray,
    tol_px: float = 3.0,
) -> Tuple[int, int]:
    """Grade a catalog against injected truths: (recovered, spurious).

    A truth is recovered when some detection lies within ``tol_px`` of its
    grid position; a detection matching no truth is spurious.
    """
    if len(truth_radec):
        tx, ty = sky_to_grid(query, truth_radec[:, 0], truth_radec[:, 1])
    else:
        tx = ty = np.zeros(0)
    if len(catalog) == 0:
        return 0, 0
    dx = catalog.x[None, :] - tx[:, None]
    dy = catalog.y[None, :] - ty[:, None]
    close = (dx * dx + dy * dy) <= tol_px * tol_px
    recovered = int(close.any(axis=1).sum()) if close.size else 0
    spurious = int((~close.any(axis=0)).sum()) if close.size else len(catalog)
    return recovered, spurious


__all__ = [
    "DetectionCatalog",
    "detect_sources",
    "difference_image",
    "epoch_time_bounds",
    "inject_transients",
    "match_detections",
    "sky_to_grid",
]
