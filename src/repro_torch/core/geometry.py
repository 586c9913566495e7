"""WCS geometry: gnomonic (TAN) projection, pixel<->sky mapping, bounds.

Counterpart of ``repro.core.geometry``.  The host-side metadata math runs in
numpy (float64, bitwise equal to the reference); the device-side warp runs
the same formulas on torch tensors, in the same operation order, so the
plain torch mapper and the CUDA kernel in ``csrc/warp.cu`` compute the
reference's sky->pixel map.

Conventions
-----------
* Sky coordinates (ra, dec) in **degrees**; RA wrap-around is not handled.
* A :class:`WCS` is parameterized by ``crval`` (sky at reference pixel),
  ``crpix`` (reference pixel, 0-based), and a 2x2 ``cd`` matrix in
  degrees/pixel mapping pixel offsets to intermediate world coordinates.
* Pixel coordinates are (x, y) = (column, row), 0-based.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

DEG2RAD = np.pi / 180.0
RAD2DEG = 180.0 / np.pi

# Flat vector layout of a WCS riding along as a per-image feature vector:
#   [crval_ra, crval_dec, crpix_x, crpix_y, cd11, cd12, cd21, cd22]
WCS_NPARAMS = 8


@dataclasses.dataclass(frozen=True)
class WCS:
    """Tangent-plane world coordinate system for one image or query grid."""

    crval: Tuple[float, float]  # (ra0, dec0) degrees
    crpix: Tuple[float, float]  # (x0, y0) pixels
    cd: Tuple[Tuple[float, float], Tuple[float, float]]  # deg / pixel

    def to_vector(self) -> np.ndarray:
        (cd11, cd12), (cd21, cd22) = self.cd
        return np.array(
            [
                self.crval[0],
                self.crval[1],
                self.crpix[0],
                self.crpix[1],
                cd11,
                cd12,
                cd21,
                cd22,
            ],
            dtype=np.float32,
        )

    @staticmethod
    def from_vector(v) -> "WCS":
        v = np.asarray(v, dtype=np.float64)
        return WCS(
            crval=(float(v[0]), float(v[1])),
            crpix=(float(v[2]), float(v[3])),
            cd=((float(v[4]), float(v[5])), (float(v[6]), float(v[7]))),
        )


# ---------------------------------------------------------------------------
# Gnomonic projection: numpy arrays (host) or torch tensors (device)
# ---------------------------------------------------------------------------


def _xp(a):
    return torch if isinstance(a, torch.Tensor) else np


def sky_to_tangent(ra, dec, ra0, dec0):
    """Project sky coords onto the tangent plane at (ra0, dec0).

    Returns intermediate world coordinates (xi, eta) in **degrees**.  Works
    on numpy arrays and on torch tensors; the operation order is the
    reference's, which the CUDA kernel repeats.
    """
    xp = _xp(ra)
    ra_r = ra * DEG2RAD
    dec_r = dec * DEG2RAD
    ra0_r = ra0 * DEG2RAD
    dec0_r = dec0 * DEG2RAD
    cosc = xp.sin(dec0_r) * xp.sin(dec_r) + xp.cos(dec0_r) * xp.cos(dec_r) * xp.cos(
        ra_r - ra0_r
    )
    xi = xp.cos(dec_r) * xp.sin(ra_r - ra0_r) / cosc
    eta = (
        xp.cos(dec0_r) * xp.sin(dec_r)
        - xp.sin(dec0_r) * xp.cos(dec_r) * xp.cos(ra_r - ra0_r)
    ) / cosc
    return xi * RAD2DEG, eta * RAD2DEG


def tangent_to_sky(xi, eta, ra0, dec0):
    """Inverse gnomonic: tangent-plane (xi, eta) degrees -> (ra, dec) degrees."""
    xi_r = xi * DEG2RAD
    eta_r = eta * DEG2RAD
    ra0_r = ra0 * DEG2RAD
    dec0_r = dec0 * DEG2RAD
    rho = np.sqrt(xi_r**2 + eta_r**2)
    c = np.arctan(rho)
    cos_c = np.cos(c)
    sin_c = np.sin(c)
    # Guard rho == 0 (point at tangent center).
    safe_rho = np.where(rho == 0, 1.0, rho)
    dec_r = np.arcsin(
        cos_c * np.sin(dec0_r) + eta_r * sin_c * np.cos(dec0_r) / safe_rho
    )
    ra_r = ra0_r + np.arctan2(
        xi_r * sin_c,
        safe_rho * np.cos(dec0_r) * cos_c - eta_r * np.sin(dec0_r) * sin_c,
    )
    dec_r = np.where(rho == 0, dec0_r, dec_r)
    ra_r = np.where(rho == 0, ra0_r, ra_r)
    return ra_r * RAD2DEG, dec_r * RAD2DEG


def pixel_to_sky(x, y, wcs_vec):
    """Pixel coords -> sky (ra, dec) via a WCS parameter vector (host numpy)."""
    ra0, dec0 = wcs_vec[0], wcs_vec[1]
    x0, y0 = wcs_vec[2], wcs_vec[3]
    cd11, cd12, cd21, cd22 = wcs_vec[4], wcs_vec[5], wcs_vec[6], wcs_vec[7]
    dx = x - x0
    dy = y - y0
    xi = cd11 * dx + cd12 * dy
    eta = cd21 * dx + cd22 * dy
    return tangent_to_sky(xi, eta, ra0, dec0)


def sky_to_pixel(ra, dec, wcs_vec):
    """Sky (ra, dec) -> pixel coords via a WCS parameter vector.

    ``wcs_vec[k]`` may be a scalar or, for a batch of images, a tensor that
    broadcasts against ``ra``/``dec`` (e.g. shape (N, 1, 1) per entry).
    """
    ra0, dec0 = wcs_vec[0], wcs_vec[1]
    x0, y0 = wcs_vec[2], wcs_vec[3]
    cd11, cd12, cd21, cd22 = wcs_vec[4], wcs_vec[5], wcs_vec[6], wcs_vec[7]
    xi, eta = sky_to_tangent(ra, dec, ra0, dec0)
    det = cd11 * cd22 - cd12 * cd21
    dx = (cd22 * xi - cd12 * eta) / det
    dy = (-cd21 * xi + cd11 * eta) / det
    return dx + x0, dy + y0


# ---------------------------------------------------------------------------
# Footprints (host-side metadata math)
# ---------------------------------------------------------------------------


def image_bounds(wcs: WCS, height: int, width: int) -> Tuple[float, float, float, float]:
    """RA/Dec bounding box of an image (min_ra, max_ra, min_dec, max_dec)."""
    xs = np.array([0.0, width - 1.0, 0.0, width - 1.0])
    ys = np.array([0.0, 0.0, height - 1.0, height - 1.0])
    ra, dec = pixel_to_sky(xs, ys, wcs.to_vector().astype(np.float64))
    return float(ra.min()), float(ra.max()), float(dec.min()), float(dec.max())


def boxes_intersect(a, b) -> bool:
    """Axis-aligned RA/Dec box intersection. Boxes are (ra0, ra1, dec0, dec1)."""
    return not (a[1] < b[0] or b[1] < a[0] or a[3] < b[2] or b[3] < a[2])


def make_grid_wcs(center_ra: float, center_dec: float, npix: int, fov_deg: float) -> WCS:
    """Query-grid WCS: square TAN grid of ``npix`` pixels spanning ``fov_deg``."""
    scale = fov_deg / npix  # deg / pixel
    return WCS(
        crval=(center_ra, center_dec),
        crpix=((npix - 1) / 2.0, (npix - 1) / 2.0),
        # +x -> +RA, as in the reference.
        cd=((scale, 0.0), (0.0, scale)),
    )
