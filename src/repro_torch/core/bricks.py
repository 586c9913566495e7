"""Brick tessellation: the survey footprint as a fixed grid of coadd cells.

Counterpart of ``repro.core.bricks``: numpy on the host, bitwise equal to
the reference.

Production surveys do not coadd per ad-hoc query; they tessellate the sky
into fixed *bricks* and materialize a coadd per (brick, band) once
(legacypipe's brick/runbrick design, NSC's healpix tiling).  Serving an
arbitrary query then costs O(bricks touched) — mosaicking cached tiles —
instead of O(images scanned).  This module owns the geometry half of that
contract (DESIGN.md §9); `CoaddEngine.materialize_bricks` and the
`BrickStore` own the execution/storage half.

The bitwise-parity contract
---------------------------
Every brick is a tile of ONE global TAN lattice: a single `WCS` anchored at
the footprint center, ``scale = brick_deg / brick_npix`` deg/px, covering
``n_rows x n_cols`` bricks of ``brick_npix`` pixels each.  A brick's output
grid is computed by running the *global* pixel indices of its tile through
`pixel_to_sky` in float64 and casting to float32 — the exact arithmetic
`mapper.query_grid_sky` performs — so the grid of any window of bricks is
bitwise-identical to the concatenation of its tiles' grids.  Because an
image whose footprint misses a tile contributes *exact zeros* at every tile
pixel (the masked-discard contract, DESIGN.md §3), and per-pack partials
accumulate in the same pack/slot order either way, the mosaic of per-brick
scans equals one fresh scan of the whole window bitwise.  That is the
parity `engine.run(..., use_bricks=True)` promises against
`engine.run_window` whenever a query is brick-aligned (`decompose`), and
tests pin with `assert_array_equal`.

Brick *plan* bounds are the true sky bounding box of the tile's pixel grid
(TAN distortion makes that differ from the nominal ``ra0 + c*brick_deg``
box by up to ~1e-3 deg across a few degrees), padded outward by half an
output pixel: any image contributing at a tile pixel then intersects the
brick's query box with a margin far above float32 rounding, so brick plans
accept a superset of the contributors — the extras contribute exact zeros.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.geometry import WCS, boxes_intersect, pixel_to_sky
from repro_torch.core.query import CoaddQuery


@dataclasses.dataclass(frozen=True)
class BrickCover:
    """A brick-aligned query footprint: a square block of lattice bricks."""

    grid: "BrickGrid"
    band: str
    r0: int
    r1: int
    c0: int
    c1: int

    @property
    def k(self) -> int:
        """Block side length in bricks (square by construction)."""
        return self.r1 - self.r0

    @property
    def bricks(self) -> List[Tuple[int, int]]:
        """Covered (row, col) cells, row-major — the mosaic tile order."""
        return [
            (r, c)
            for r in range(self.r0, self.r1)
            for c in range(self.c0, self.c1)
        ]

    @property
    def tag(self) -> Tuple[str, int, int, int, int]:
        """Hashable identity of this cover — the serving layer's popularity
        accounting key (DESIGN.md §10): per-window hit/miss counts decide
        what to materialize next and what the cost-aware LRU should pin."""
        return (self.band, self.r0, self.r1, self.c0, self.c1)


@dataclasses.dataclass(frozen=True)
class BrickGrid:
    """Deterministic tessellation of a sky rectangle into coadd bricks.

    ``(ra0, dec0)`` is the lattice's lower-left corner (nominal degrees);
    bricks are ``brick_deg`` on a side, ``brick_npix`` output pixels each,
    ``n_rows`` strips of ``n_cols`` bricks.  Brick (r, c) nominally spans
    ``[ra0 + c*brick_deg, ra0 + (c+1)*brick_deg)`` x the analogous dec
    interval — half-open, so the nominal boxes partition the lattice
    rectangle with no gaps and no double cover (property-tested).
    """

    ra0: float
    dec0: float
    brick_deg: float
    brick_npix: int
    n_rows: int
    n_cols: int

    # ----- construction -----
    @staticmethod
    def for_bounds(
        ra0: float,
        dec0: float,
        ra_span: float,
        dec_span: float,
        brick_deg: float = 0.25,
        brick_npix: int = 64,
    ) -> "BrickGrid":
        """Smallest lattice of whole bricks covering the given rectangle."""
        if brick_deg <= 0 or brick_npix <= 0:
            raise ValueError(
                f"brick_deg and brick_npix must be positive, got "
                f"{brick_deg}, {brick_npix}"
            )
        if ra_span <= 0 or dec_span <= 0:
            raise ValueError(
                f"footprint spans must be positive, got {ra_span}, {dec_span}"
            )
        # ceil with a relative epsilon so an exact multiple does not gain a
        # spurious extra row to float division noise.
        n_cols = int(np.ceil(ra_span / brick_deg - 1e-9))
        n_rows = int(np.ceil(dec_span / brick_deg - 1e-9))
        return BrickGrid(ra0, dec0, brick_deg, brick_npix,
                         max(n_rows, 1), max(n_cols, 1))

    @staticmethod
    def for_survey(config, brick_deg: float = 0.25,
                   brick_npix: int = 64) -> "BrickGrid":
        """Lattice covering a `SurveyConfig`'s nominal footprint."""
        return BrickGrid.for_bounds(
            config.ra_start,
            config.dec_min,
            config.ra_span,
            config.n_camcols * config.camcol_dec_deg,
            brick_deg,
            brick_npix,
        )

    # ----- lattice geometry -----
    @property
    def scale(self) -> float:
        """Output pixel scale, deg/px — uniform across the lattice."""
        return self.brick_deg / self.brick_npix

    @property
    def n_bricks(self) -> int:
        return self.n_rows * self.n_cols

    def lattice_wcs(self) -> WCS:
        """The single global TAN system every brick grid is a tile of."""
        w = self.n_cols * self.brick_npix
        h = self.n_rows * self.brick_npix
        return WCS(
            crval=(
                self.ra0 + 0.5 * self.n_cols * self.brick_deg,
                self.dec0 + 0.5 * self.n_rows * self.brick_deg,
            ),
            crpix=((w - 1) / 2.0, (h - 1) / 2.0),
            cd=((self.scale, 0.0), (0.0, self.scale)),
        )

    def _window_sky64(
        self, r0: int, r1: int, c0: int, c1: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 sky coords of a brick window's pixel grid.

        Uses *global* lattice pixel indices, so any window slice and any
        single brick produce bitwise-identical values where they overlap —
        the foundation of the mosaic parity contract.
        """
        self._check_window(r0, r1, c0, c1)
        b = self.brick_npix
        g = self.lattice_wcs().to_vector().astype(np.float64)
        xs, ys = np.meshgrid(
            np.arange(c0 * b, c1 * b, dtype=np.float64),
            np.arange(r0 * b, r1 * b, dtype=np.float64),
        )
        return pixel_to_sky(xs, ys, g)

    def window_sky(
        self, r0: int, r1: int, c0: int, c1: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Float32 output grid (ra, dec) of a brick window — the
        `CoaddPlan.grid_sky` override for window-fresh and brick scans."""
        ra, dec = self._window_sky64(r0, r1, c0, c1)
        return ra.astype(np.float32), dec.astype(np.float32)

    def brick_sky(self, row: int, col: int) -> Tuple[np.ndarray, np.ndarray]:
        """One brick's (brick_npix, brick_npix) output grid."""
        return self.window_sky(row, row + 1, col, col + 1)

    def window_bounds(
        self, r0: int, r1: int, c0: int, c1: int
    ) -> Tuple[float, float, float, float]:
        """True sky bbox of a window's pixel grid, padded half a pixel out.

        The pad guarantees every image contributing flux at a window pixel
        intersects this box with margin well above float32 rounding; the
        extra images an inflated box admits contribute exact zeros.
        """
        ra, dec = self._window_sky64(r0, r1, c0, c1)
        pad = 0.5 * self.scale
        return (
            float(ra.min()) - pad,
            float(ra.max()) + pad,
            float(dec.min()) - pad,
            float(dec.max()) + pad,
        )

    def brick_bounds(self, row: int, col: int) -> Tuple[float, float, float, float]:
        return self.window_bounds(row, row + 1, col, col + 1)

    def nominal_box(self, row: int, col: int) -> Tuple[float, float, float, float]:
        """Nominal (ra_min, ra_max, dec_min, dec_max) cell — half-open
        partition semantics; region filters intersect against this."""
        return (
            self.ra0 + col * self.brick_deg,
            self.ra0 + (col + 1) * self.brick_deg,
            self.dec0 + row * self.brick_deg,
            self.dec0 + (row + 1) * self.brick_deg,
        )

    # ----- queries -----
    def window_query(
        self, r0: int, r1: int, c0: int, c1: int, band: str
    ) -> CoaddQuery:
        """The canonical brick-aligned query for a square window of bricks.

        Queries built here (and only these) decompose back into their
        brick cover; the output grid is the lattice window, threaded to the
        executor as a plan grid override.
        """
        self._check_window(r0, r1, c0, c1)
        if r1 - r0 != c1 - c0:
            raise ValueError(
                f"brick windows must be square, got {r1 - r0}x{c1 - c0}"
            )
        ra_min, ra_max, dec_min, dec_max = self.window_bounds(r0, r1, c0, c1)
        return CoaddQuery(
            band=band,
            ra_bounds=(ra_min, ra_max),
            dec_bounds=(dec_min, dec_max),
            npix=(r1 - r0) * self.brick_npix,
        )

    def brick_query(self, row: int, col: int, band: str) -> CoaddQuery:
        """The materialization query for one (brick, band) cell."""
        return self.window_query(row, row + 1, col, col + 1, band)

    def decompose(self, query: CoaddQuery) -> Optional[BrickCover]:
        """The brick cover of a query, or None when it is not brick-aligned.

        Alignment — the "brick and query parameters agree" half of the
        parity contract — means: no time bounds (bricks stack every epoch),
        npix an exact square multiple of ``brick_npix``, and bounds equal
        (to 1e-6 deg, ~4 mas — far below the pixel scale) to the canonical
        `window_query` of some in-lattice block.  Anything else returns
        None and `run(use_bricks=True)` falls back to the ordinary path.
        """
        if query.time_bounds is not None:
            return None
        k, rem = divmod(query.npix, self.brick_npix)
        if rem or k == 0:
            return None
        # Invert the nominal lattice position, then verify exactly: the true
        # bbox deviates from nominal by TAN distortion (~1e-3 deg) plus the
        # half-pixel pad, both far below half a brick.
        pad = 0.5 * self.scale
        c0 = int(round((query.ra_bounds[0] + pad - self.ra0) / self.brick_deg))
        r0 = int(round((query.dec_bounds[0] + pad - self.dec0) / self.brick_deg))
        if not (0 <= r0 and r0 + k <= self.n_rows
                and 0 <= c0 and c0 + k <= self.n_cols):
            return None
        cand = self.window_query(r0, r0 + k, c0, c0 + k, query.band)
        if not np.allclose(cand.bounds, query.bounds, rtol=0.0, atol=1e-6):
            return None
        return BrickCover(self, query.band, r0, r0 + k, c0, c0 + k)

    def bricks(
        self, region: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None
    ) -> List[Tuple[int, int]]:
        """All (row, col) cells, optionally only those whose nominal box
        intersects ``region = (ra_bounds, dec_bounds)`` — the
        `materialize_bricks(region=...)` filter."""
        cells = [
            (r, c) for r in range(self.n_rows) for c in range(self.n_cols)
        ]
        if region is None:
            return cells
        (ra_lo, ra_hi), (dec_lo, dec_hi) = region
        box = (ra_lo, ra_hi, dec_lo, dec_hi)
        return [
            (r, c) for (r, c) in cells
            if boxes_intersect(self.nominal_box(r, c), box)
        ]

    def locate(self, ra: float, dec: float) -> Optional[Tuple[int, int]]:
        """The unique cell whose half-open nominal box contains a point,
        or None outside the lattice (the no-double-cover witness)."""
        c = int(np.floor((ra - self.ra0) / self.brick_deg))
        r = int(np.floor((dec - self.dec0) / self.brick_deg))
        if 0 <= r < self.n_rows and 0 <= c < self.n_cols:
            return (r, c)
        return None

    def _check_window(self, r0: int, r1: int, c0: int, c1: int) -> None:
        if not (0 <= r0 < r1 <= self.n_rows and 0 <= c0 < c1 <= self.n_cols):
            raise ValueError(
                f"window rows [{r0},{r1}) cols [{c0},{c1}) outside lattice "
                f"{self.n_rows}x{self.n_cols}"
            )


__all__ = ["BrickCover", "BrickGrid"]
