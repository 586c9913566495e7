"""Coadd queries.

A query (paper §2.1, Algorithm 1) selects a bandpass filter and an RA/Dec
bounding box, and defines the common output coordinate system the accepted
images are projected onto.  We additionally support the paper's proposed
time-bounds extension (§6, future work) as an optional [t0, t1] window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.geometry import WCS, make_grid_wcs

BANDS = ("u", "g", "r", "i", "z")
BAND_INDEX = {b: i for i, b in enumerate(BANDS)}


@dataclasses.dataclass(frozen=True)
class CoaddQuery:
    """One coaddition request.

    Attributes:
      band: bandpass name, one of ``BANDS``.
      ra_bounds / dec_bounds: query sky box in degrees.
      npix: output grid is ``npix x npix``.
      time_bounds: optional (t0, t1) observation-time window (paper §6).
    """

    band: str
    ra_bounds: Tuple[float, float]
    dec_bounds: Tuple[float, float]
    npix: int = 128
    time_bounds: Optional[Tuple[float, float]] = None

    @property
    def band_id(self) -> int:
        return BAND_INDEX[self.band]

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        return (
            self.ra_bounds[0],
            self.ra_bounds[1],
            self.dec_bounds[0],
            self.dec_bounds[1],
        )

    @property
    def center(self) -> Tuple[float, float]:
        return (
            0.5 * (self.ra_bounds[0] + self.ra_bounds[1]),
            0.5 * (self.dec_bounds[0] + self.dec_bounds[1]),
        )

    @property
    def fov_deg(self) -> float:
        return max(
            self.ra_bounds[1] - self.ra_bounds[0],
            self.dec_bounds[1] - self.dec_bounds[0],
        )

    def grid_wcs(self) -> WCS:
        ra_c, dec_c = self.center
        return make_grid_wcs(ra_c, dec_c, self.npix, self.fov_deg)

    def grid_wcs_vector(self) -> np.ndarray:
        return self.grid_wcs().to_vector()

    def time_window(self) -> Tuple[float, float]:
        if self.time_bounds is None:
            return (-np.inf, np.inf)
        return self.time_bounds
