"""Prefilters: glob-style metadata pruning and the exact "SQL" spatial index.

Paper §4.1.1: the SDSS directory layout encodes (band, camcol) in filenames,
so a glob like ``corr/[234]/fpC-*-[g][234]-*.fit`` excludes irrelevant files
before the job starts.  The filter is *single-axis* (camcol = declination
strip); it cannot prune along RA, so false positives remain and are
discarded inside the mappers (Fig. 6).

Paper §4.1.4: an external SQL database over per-file metadata (band +
sky-bounds + sequence-file offsets) returns *exactly* the contributing
files — zero false positives — which are then gathered from the containers
via the index.

Here the glob becomes a vectorized mask over metadata columns (band equality
+ camcol/dec-strip overlap only), and "SQL" becomes `SpatialIndex`, a
host-side sorted-interval index supporting exact band+box+time selection.
Both operate on metadata only — never pixels — exactly like the paper.
Counterpart of ``repro.core.prefilter``, bitwise equal on the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.query import CoaddQuery
from repro_torch.core.seqfile import PackedDataset
from repro_torch.core.survey import Survey


def glob_file_mask(tab: dict, query: CoaddQuery, camcol_dec_ranges: np.ndarray) -> np.ndarray:
    """Glob-equivalent prefilter over individual files.

    Accepts files whose band matches and whose *camcol strip* (not the file's
    own RA bounds!) overlaps the query dec range.  Single-axis, with false
    positives along RA — faithful to §4.1.1.
    """
    band_ok = tab["band_id"] == query.band_id
    dec0, dec1 = query.dec_bounds
    strips = camcol_dec_ranges[tab["camcol"]]
    dec_ok = (strips[:, 1] >= dec0) & (strips[:, 0] <= dec1)
    return band_ok & dec_ok


def glob_pack_mask(ds: PackedDataset, query: CoaddQuery, camcol_dec_ranges: np.ndarray) -> np.ndarray:
    """Container-level pruning for structured packs (paper §4.1.3).

    Unstructured packs (key -1) can never be pruned — the paper's point.
    """
    band_ok = (ds.pack_band == query.band_id) | (ds.pack_band < 0)
    cc = np.clip(ds.pack_camcol, 0, None)
    strips = camcol_dec_ranges[cc]
    dec0, dec1 = query.dec_bounds
    dec_ok = (strips[:, 1] >= dec0) & (strips[:, 0] <= dec1) | (ds.pack_camcol < 0)
    return band_ok & dec_ok


def camcol_dec_table(survey: Survey) -> np.ndarray:
    """(n_camcols, 2) dec range per camera column, from survey metadata."""
    tab = survey.meta_table()
    n = survey.config.n_camcols
    out = np.zeros((n, 2), np.float32)
    for c in range(n):
        sel = tab["camcol"] == c
        out[c, 0] = tab["dec_min"][sel].min()
        out[c, 1] = tab["dec_max"][sel].max()
    return out


@dataclasses.dataclass
class SpatialIndex:
    """Exact metadata index over the archive (the paper's external SQL DB).

    Stores band, RA/Dec bounds, observation time and the sequence-file
    location of every image; `select` answers a query with exactly the
    overlapping image ids (no false positives / negatives).
    """

    image_id: np.ndarray
    band_id: np.ndarray
    ra_min: np.ndarray
    ra_max: np.ndarray
    dec_min: np.ndarray
    dec_max: np.ndarray
    t_obs: np.ndarray
    order: np.ndarray  # image ids sorted by ra_min, per band

    @staticmethod
    def build(survey: Survey) -> "SpatialIndex":
        tab = survey.meta_table()
        return SpatialIndex(
            image_id=tab["image_id"],
            band_id=tab["band_id"],
            ra_min=tab["ra_min"],
            ra_max=tab["ra_max"],
            dec_min=tab["dec_min"],
            dec_max=tab["dec_max"],
            t_obs=tab["t_obs"],
            order=np.argsort(tab["ra_min"], kind="stable"),
        )

    def select(self, query: CoaddQuery) -> np.ndarray:
        """Exact overlap selection (band AND box AND optional time window)."""
        ra0, ra1 = query.ra_bounds
        dec0, dec1 = query.dec_bounds
        t0, t1 = query.time_window()
        m = (
            (self.band_id == query.band_id)
            & (self.ra_max >= ra0)
            & (self.ra_min <= ra1)
            & (self.dec_max >= dec0)
            & (self.dec_min <= dec1)
            & (self.t_obs >= t0)
            & (self.t_obs <= t1)
        )
        return self.image_id[m]
