"""Synthetic SDSS Stripe-82-like survey.

The paper's testbed is a 100k-image / 600GB subset of SDSS Stripe 82: a
drift-scan survey whose 30-CCD camera (5 bandpass rows x 6 camcol strips,
Fig. 3) tiles a +-1.25 deg declination stripe with ~75-visit coverage
(Fig. 4).  We generate a seeded, fully deterministic miniature with the same
*structure* — that structure (band rows, camcol strips, repeated runs over
the same RA window) is exactly what the paper's prefilters exploit, so the
synthetic survey preserves every property the experiments measure:

* images belong to (run, camcol, band, field);
* camcol determines a declination strip (single-axis spatial prefilter);
* fields advance along RA within a run; runs revisit the same RA window with
  small dec jitter (coverage depth ~= n_runs);
* each image has its own TAN WCS with small per-run rotation jitter;
* pixels = point sources from a *global* seeded catalog + background + noise,
  so overlapping images see the same sky (coaddition is meaningful: SNR of
  the stack grows ~ sqrt(depth), Fig. 2).

Everything is numpy on the host — the survey plays the role of the FITS
archive; packing it into device-resident containers is `seqfile.py`'s job.
Counterpart of ``repro.core.survey``: the same seeded streams, so pixels,
WCS and metadata are bitwise equal to the reference's.  Frames can render
in a process pool (``make_survey(cfg, processes=n)``); each frame draws from
its own seeded generator, so the pool changes nothing in the output.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from typing import List, Optional

import numpy as np

from repro_torch.core.geometry import WCS, image_bounds, sky_to_pixel
from repro_torch.core.query import BANDS


@dataclasses.dataclass(frozen=True)
class SurveyConfig:
    n_runs: int = 8                 # epochs revisiting the stripe
    n_camcols: int = 6              # camera columns = dec strips (Fig. 3)
    n_bands: int = 5                # u, g, r, i, z rows
    n_fields: int = 12              # fields along RA per (run, camcol, band)
    height: int = 32                # image rows (dec)
    width: int = 32                 # image cols (ra)
    ra_start: float = 37.0          # deg; the paper's window is RA 37..40
    field_ra_deg: float = 0.25      # RA span of one field
    camcol_dec_deg: float = 0.4     # dec span of one camcol strip
    dec_center: float = 0.0         # stripe center (Stripe 82: equatorial)
    n_sources: int = 600            # global point-source catalog size
    source_flux_max: float = 100.0
    psf_sigma_px: float = 1.2
    # Measured-PSF calibration products (paper footnote 2): every image gets
    # an empirical PSF stamp — an elliptical Moffat at the run's seeing with
    # per-image ellipticity jitter — the way production pipelines carry a
    # fitted PSF model per exposure.  `moffat_beta=None` degrades the stamps
    # to circular Gaussians (the closure-testable case); `psf_stamps=False`
    # drops them entirely, which is what exercises the engine's separable
    # Gaussian fallback.
    psf_stamps: bool = True
    psf_stamp_size: int = 13        # odd tap grid; also the kernel-bank width
    moffat_beta: Optional[float] = 3.5
    psf_ellip_jitter: float = 0.08  # per-image |e| scale (e1, e2 components)
    background: float = 10.0
    noise_sigma: float = 3.0
    rotation_jitter_deg: float = 0.4
    pointing_jitter_frac: float = 0.05
    seed: int = 82

    @property
    def n_images(self) -> int:
        return self.n_runs * self.n_camcols * self.n_bands * self.n_fields

    @property
    def ra_span(self) -> float:
        return self.n_fields * self.field_ra_deg

    @property
    def dec_min(self) -> float:
        return self.dec_center - 0.5 * self.n_camcols * self.camcol_dec_deg


@dataclasses.dataclass
class SurveyImage:
    """One CCD frame + its metadata (a FITS file, morally)."""

    image_id: int
    run: int
    camcol: int            # 0-based camera column (dec strip)
    band_id: int           # 0..4 -> u g r i z
    field: int
    t_obs: float
    wcs: WCS
    bounds: tuple          # (ra_min, ra_max, dec_min, dec_max)
    pixels: np.ndarray     # (H, W) float32
    psf_sigma: float = 1.2  # per-image seeing (px); drives PSF matching
    psf_stamp: Optional[np.ndarray] = None  # (S, S) measured PSF model, sum 1

    @property
    def band(self) -> str:
        return BANDS[self.band_id]


@dataclasses.dataclass
class Survey:
    config: SurveyConfig
    images: List[SurveyImage]
    catalog_ra: np.ndarray
    catalog_dec: np.ndarray
    catalog_flux: np.ndarray   # (n_sources, n_bands)

    def __len__(self) -> int:
        return len(self.images)

    def meta_table(self) -> dict:
        """Columnar metadata for the whole archive (the prefilters' input)."""
        n = len(self.images)
        tab = {
            "image_id": np.arange(n, dtype=np.int32),
            "run": np.array([im.run for im in self.images], np.int32),
            "camcol": np.array([im.camcol for im in self.images], np.int32),
            "band_id": np.array([im.band_id for im in self.images], np.int32),
            "field": np.array([im.field for im in self.images], np.int32),
            "t_obs": np.array([im.t_obs for im in self.images], np.float32),
            "ra_min": np.array([im.bounds[0] for im in self.images], np.float32),
            "ra_max": np.array([im.bounds[1] for im in self.images], np.float32),
            "dec_min": np.array([im.bounds[2] for im in self.images], np.float32),
            "dec_max": np.array([im.bounds[3] for im in self.images], np.float32),
            "psf_sigma": np.array([im.psf_sigma for im in self.images], np.float32),
            "wcs": np.stack([im.wcs.to_vector() for im in self.images]),
        }
        return tab


def _render_image(
    wcs: WCS,
    height: int,
    width: int,
    cat_ra: np.ndarray,
    cat_dec: np.ndarray,
    cat_flux: np.ndarray,
    psf_sigma: float,
    background: float,
    noise_sigma: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Render point sources through a Gaussian PSF onto the frame."""
    v = wcs.to_vector().astype(np.float64)
    sx, sy = sky_to_pixel(cat_ra, cat_dec, v)
    margin = 4.0 * psf_sigma
    keep = (
        (sx > -margin) & (sx < width - 1 + margin) &
        (sy > -margin) & (sy < height - 1 + margin)
    )
    img = np.full((height, width), background, dtype=np.float64)
    if keep.any():
        xs = sx[keep]
        ys = sy[keep]
        fl = cat_flux[keep]
        yy, xx = np.mgrid[0:height, 0:width]
        # (n_kept, H, W) Gaussian splats; fine at miniature scale.
        d2 = (xx[None] - xs[:, None, None]) ** 2 + (yy[None] - ys[:, None, None]) ** 2
        img += (fl[:, None, None] * np.exp(-0.5 * d2 / psf_sigma**2)).sum(0)
    img += rng.normal(0.0, noise_sigma, size=img.shape)
    return img.astype(np.float32)


def render_psf_stamp(
    sigma: float,
    size: int,
    beta: Optional[float] = None,
    e1: float = 0.0,
    e2: float = 0.0,
) -> np.ndarray:
    """(size, size) unit-sum empirical PSF stamp, centered.

    ``beta=None`` renders a circular/elliptical Gaussian; otherwise an
    elliptical Moffat whose FWHM matches a Gaussian of width ``sigma`` —
    Moffat wings are the canonical non-Gaussianity of real seeing, which is
    exactly what makes the Fourier least-squares homogenization kernel a
    different object from the closed-form Gaussian matching kernel.
    The (e1, e2) shear components tilt the quadratic form at unit area.
    """
    if size % 2 == 0:
        raise ValueError(f"stamp size must be odd, got {size}")
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    xx -= c
    yy -= c
    # Unit-determinant shear: |e| < 1 keeps the form positive definite.
    r2 = (1 + e1) * xx**2 + (1 - e1) * yy**2 + 2 * e2 * xx * yy
    r2 /= max(np.sqrt(max(1.0 - e1**2 - e2**2, 1e-6)), 1e-6)
    if beta is None:
        img = np.exp(-0.5 * r2 / max(sigma, 1e-6) ** 2)
    else:
        fwhm = 2.0 * np.sqrt(2.0 * np.log(2.0)) * sigma
        alpha = fwhm / (2.0 * np.sqrt(2.0 ** (1.0 / beta) - 1.0))
        img = (1.0 + r2 / alpha**2) ** (-beta)
    return (img / img.sum()).astype(np.float32)


def _render_task(args) -> np.ndarray:
    """One frame's render from picklable arguments (pool worker entry)."""
    (wcs, height, width, cat_ra, cat_dec, flux, seeing, background,
     noise_sigma, pix_seed) = args
    return _render_image(
        wcs, height, width, cat_ra, cat_dec, flux, seeing, background,
        noise_sigma, np.random.default_rng(pix_seed),
    )


def make_survey(config: Optional[SurveyConfig] = None, processes: int = 1) -> Survey:
    """Render the seeded survey; ``processes > 1`` renders frames in a pool."""
    cfg = config or SurveyConfig()
    rng = np.random.default_rng(cfg.seed)

    # Global source catalog shared by all epochs (the actual sky).
    cat_ra = rng.uniform(cfg.ra_start, cfg.ra_start + cfg.ra_span, cfg.n_sources)
    cat_dec = rng.uniform(
        cfg.dec_min, cfg.dec_min + cfg.n_camcols * cfg.camcol_dec_deg, cfg.n_sources
    )
    # Power-law-ish fluxes, band-correlated.
    base = rng.pareto(2.0, cfg.n_sources) * cfg.source_flux_max / 10.0
    band_scale = rng.uniform(0.6, 1.4, size=(cfg.n_sources, cfg.n_bands))
    cat_flux = (base[:, None] * band_scale).astype(np.float64)

    ra_scale = cfg.field_ra_deg / cfg.width       # deg / px along RA
    dec_scale = cfg.camcol_dec_deg / cfg.height   # deg / px along Dec

    images: List[SurveyImage] = []
    tasks = []
    image_id = 0
    for run in range(cfg.n_runs):
        run_rng = np.random.default_rng(cfg.seed + 1000 + run)
        # Per-run pointing and rotation jitter (astrometric registration is
        # what makes projection non-trivial).
        dec_jit = run_rng.normal(0.0, cfg.pointing_jitter_frac * cfg.camcol_dec_deg)
        ra_phase = run_rng.uniform(-cfg.pointing_jitter_frac, cfg.pointing_jitter_frac) * cfg.field_ra_deg
        theta = np.deg2rad(run_rng.normal(0.0, cfg.rotation_jitter_deg))
        # Per-run seeing: each run's PSF width jitters around the nominal.
        seeing = float(cfg.psf_sigma_px * run_rng.uniform(0.85, 1.35))
        rot = np.array(
            [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
        )
        cd = rot @ np.array([[ra_scale, 0.0], [0.0, dec_scale]])
        for camcol in range(cfg.n_camcols):
            dec_c = cfg.dec_min + (camcol + 0.5) * cfg.camcol_dec_deg + dec_jit
            for field in range(cfg.n_fields):
                ra_c = cfg.ra_start + (field + 0.5) * cfg.field_ra_deg + ra_phase
                wcs = WCS(
                    crval=(ra_c, dec_c),
                    crpix=((cfg.width - 1) / 2.0, (cfg.height - 1) / 2.0),
                    cd=((cd[0, 0], cd[0, 1]), (cd[1, 0], cd[1, 1])),
                )
                bounds = image_bounds(wcs, cfg.height, cfg.width)
                for band_id in range(cfg.n_bands):
                    pix_seed = cfg.seed + 7 * image_id + 13 * band_id + 1
                    # Separate, sequence-seeded stream for the stamp jitter:
                    # it never perturbs the pixel noise draws.
                    stamp = None
                    if cfg.psf_stamps:
                        stamp_rng = np.random.default_rng(
                            (cfg.seed, 2, image_id)
                        )
                        e1, e2 = stamp_rng.normal(
                            0.0, cfg.psf_ellip_jitter, size=2
                        ).clip(-0.3, 0.3)
                        stamp = render_psf_stamp(
                            seeing, cfg.psf_stamp_size, cfg.moffat_beta,
                            float(e1), float(e2),
                        )
                    tasks.append((
                        wcs, cfg.height, cfg.width, cat_ra, cat_dec,
                        cat_flux[:, band_id], seeing, cfg.background,
                        cfg.noise_sigma, pix_seed,
                    ))
                    images.append(
                        SurveyImage(
                            image_id=image_id,
                            run=run,
                            camcol=camcol,
                            band_id=band_id,
                            field=field,
                            t_obs=float(run * 100 + field),
                            wcs=wcs,
                            bounds=bounds,
                            pixels=None,
                            psf_sigma=seeing,
                            psf_stamp=stamp,
                        )
                    )
                    image_id += 1
    if processes > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes) as pool:
            frames = pool.map(_render_task, tasks, chunksize=8)
    else:
        frames = [_render_task(t) for t in tasks]
    for im, px in zip(images, frames):
        im.pixels = px
    return Survey(cfg, images, cat_ra, cat_dec, cat_flux)
