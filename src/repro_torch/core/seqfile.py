"""Sequence-file containers: packing many small images into few large arrays.

Counterpart of ``repro.core.seqfile`` (host half).  Paper §4.1.2–4.1.3:
Hadoop performs poorly on many small files, so *sequence files* concatenate
small files into few large indexed containers.  Two layouts are compared:

* **unstructured** — FITS files assigned to containers at random (Fig. 9 top).
  No container-level pruning is possible; every container must be read.
* **structured** — one container family per (band, camcol) CCD (Fig. 9
  bottom), so whole containers are pruned by the same glob logic that
  prefilters raw files.

A container is a dense ``(cap, H, W)`` pixel array plus columnar metadata.
Packing is numpy on the host and bitwise equal to the reference;
`PackedDataset.to_device` makes one layout resident on a torch device as a
`DevicePackedDataset`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.survey import Survey

META_COLS = (
    "image_id",
    "run",
    "camcol",
    "band_id",
    "field",
)
FLOAT_COLS = ("t_obs", "ra_min", "ra_max", "dec_min", "dec_max", "psf_sigma")


@dataclasses.dataclass
class DevicePackedDataset:
    """Device-resident form of a `PackedDataset`.

    The whole layout lives on the device, uploaded **once** and cached by the
    engine, so repeated queries never re-transfer pixels.  Shapes mirror
    `PackedDataset`; arrays are torch tensors on one device.
    """

    pixels: torch.Tensor            # (P, cap, H, W) float32
    wcs: torch.Tensor               # (P, cap, 8) float32
    ints: Dict[str, torch.Tensor]   # (P, cap) int32 each; empty slots have
                                    #   image_id -1 (rejected by acceptance)
    floats: Dict[str, torch.Tensor] # (P, cap) float32 each

    @property
    def n_packs(self) -> int:
        return self.pixels.shape[0]

    @property
    def capacity(self) -> int:
        return self.pixels.shape[1]

    @property
    def nbytes(self) -> int:
        """Device bytes the layout occupies."""
        tensors = [self.pixels, self.wcs, *self.ints.values(), *self.floats.values()]
        return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class SlotRemap:
    """Slot-index remap from a layout's (P, cap) grid onto a reblocked one.

    Produced by `PackedDataset.reblock`; `apply` rewrites a plan gate built
    against the original layout into the reblocked coordinates.  Invalid
    source slots map to -1 and never appear in a gate (plans AND with
    ``valid``), so the scatter below only ever writes real destinations.
    """

    rb_pack: np.ndarray            # (P, cap) int32 — destination pack or -1
    rb_slot: np.ndarray            # (P, cap) int32 — destination slot or -1
    shape: Tuple[int, int]         # reblocked (n_packs, capacity)

    def apply(self, gate: np.ndarray) -> np.ndarray:
        """(P, cap) bool gate -> equivalent gate over the reblocked layout."""
        out = np.zeros(self.shape, bool)
        out[self.rb_pack[gate], self.rb_slot[gate]] = True
        return out


@dataclasses.dataclass
class PackedDataset:
    """A set of sequence-file containers.

    pixels:  (P, cap, H, W) float32 — container pixel payloads.
    wcs:     (P, cap, 8)    float32 — per-image WCS vectors.
    valid:   (P, cap)       bool    — slot occupancy (containers may be ragged).
    int metadata columns: (P, cap) int32 each; float columns likewise.
    pack_band / pack_camcol: (P,) int32 — container key for structured packs
      (-1 where mixed, i.e. unstructured).
    """

    layout: str  # "per_file" | "unstructured" | "structured"
    pixels: np.ndarray
    wcs: np.ndarray
    valid: np.ndarray
    ints: Dict[str, np.ndarray]
    floats: Dict[str, np.ndarray]
    pack_band: np.ndarray
    pack_camcol: np.ndarray
    index: Dict[int, Tuple[int, int]]  # image_id -> (pack, slot)
    # Measured-PSF calibration column: a (P, cap, S, S) stamp per slot, or
    # None when the survey carries none.  Host-only.
    psf_stamps: Optional[np.ndarray] = None

    @property
    def n_packs(self) -> int:
        return self.pixels.shape[0]

    @property
    def capacity(self) -> int:
        return self.pixels.shape[1]

    @property
    def n_images(self) -> int:
        return int(self.valid.sum())

    def image_hw(self) -> Tuple[int, int]:
        return self.pixels.shape[2], self.pixels.shape[3]

    def to_device(self, device) -> DevicePackedDataset:
        """Upload the whole layout to ``device``, once.

        With no streaming residency (a later slice), this is the only place
        pack pixels cross host->device; everything downstream indexes and
        masks the resident tensors on the device.
        """
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        return DevicePackedDataset(
            pixels=put(self.pixels),
            wcs=put(self.wcs),
            ints={k: put(v) for k, v in self.ints.items()},
            floats={k: put(v) for k, v in self.floats.items()},
        )

    def slot_mask(self, image_ids) -> np.ndarray:
        """(P, cap) bool gate selecting exactly `image_ids` (the SQL splits).

        Host-side and metadata-only — the device never sees the id list,
        just this static-shape mask.
        """
        mask = np.zeros((self.n_packs, self.capacity), bool)
        for i in image_ids:
            p, s = self.index[int(i)]
            mask[p, s] = True
        return mask

    def reblock(self, capacity: int) -> Tuple["PackedDataset", "SlotRemap"]:
        """Re-pack into dense super-packs of ``capacity`` slots.

        The per-file layout (P=N, cap=1) pays one scan step per *image*;
        reblocking re-packs occupied slots, in (band, camcol) order, into
        ceil(N/capacity) dense super-packs, and the returned `SlotRemap`
        rewrites any (P, cap) plan gate into the reblocked coordinates — so
        which *files* a method locates is untouched while execution scans
        ~N/capacity packs.  The (band, camcol) order keeps glob-prefiltered
        gates contiguous, so they stay sparse in pack space too.
        """
        pp, ss = np.nonzero(self.valid)
        order = np.lexsort(
            (self.ints["camcol"][pp, ss], self.ints["band_id"][pp, ss])
        )
        pp, ss = pp[order], ss[order]
        n = len(pp)
        if n == 0:
            raise ValueError("cannot reblock an empty dataset")
        n_packs = int(np.ceil(n / capacity))
        h, w = self.image_hw()
        dest_p = np.arange(n) // capacity
        dest_s = np.arange(n) % capacity
        pixels = np.zeros((n_packs, capacity, h, w), np.float32)
        wcs = np.zeros((n_packs, capacity, 8), np.float32)
        valid = np.zeros((n_packs, capacity), bool)
        ints = {k: np.full((n_packs, capacity), -1, np.int32) for k in self.ints}
        floats = {k: np.zeros((n_packs, capacity), np.float32) for k in self.floats}
        pixels[dest_p, dest_s] = self.pixels[pp, ss]
        wcs[dest_p, dest_s] = self.wcs[pp, ss]
        valid[dest_p, dest_s] = True
        psf_stamps = None
        if self.psf_stamps is not None:
            psf_stamps = np.zeros(
                (n_packs, capacity) + self.psf_stamps.shape[2:], np.float32
            )
            psf_stamps[dest_p, dest_s] = self.psf_stamps[pp, ss]
        for k in self.ints:
            ints[k][dest_p, dest_s] = self.ints[k][pp, ss]
        for k in self.floats:
            floats[k][dest_p, dest_s] = self.floats[k][pp, ss]
        index = {
            int(ints["image_id"][p, s]): (int(p), int(s))
            for p, s in zip(dest_p, dest_s)
        }
        # Container keys: uniform within a super-pack or -1 (mixed).
        def pack_key(col):
            vals = np.where(valid, col, -1)
            first = vals[np.arange(n_packs), 0]
            uniform = np.all((vals == first[:, None]) | ~valid, axis=1)
            return np.where(uniform, first, -1).astype(np.int32)

        ds = PackedDataset(
            layout=self.layout,
            pixels=pixels,
            wcs=wcs,
            valid=valid,
            ints=ints,
            floats=floats,
            pack_band=pack_key(ints["band_id"]),
            pack_camcol=pack_key(ints["camcol"]),
            index=index,
            psf_stamps=psf_stamps,
        )
        rb_pack = np.full(self.valid.shape, -1, np.int32)
        rb_slot = np.full(self.valid.shape, -1, np.int32)
        rb_pack[pp, ss] = dest_p
        rb_slot[pp, ss] = dest_s
        return ds, SlotRemap(rb_pack, rb_slot, (n_packs, capacity))


def _emit(
    layout: str,
    groups: List[np.ndarray],
    survey: Survey,
    group_band: List[int],
    group_camcol: List[int],
) -> PackedDataset:
    tab = survey.meta_table()
    h, w = survey.config.height, survey.config.width
    cap = max(len(g) for g in groups)
    P = len(groups)
    pixels = np.zeros((P, cap, h, w), np.float32)
    wcs = np.zeros((P, cap, 8), np.float32)
    valid = np.zeros((P, cap), bool)
    ints = {k: np.full((P, cap), -1, np.int32) for k in META_COLS}
    floats = {k: np.zeros((P, cap), np.float32) for k in FLOAT_COLS}
    index: Dict[int, Tuple[int, int]] = {}
    stamp0 = survey.images[0].psf_stamp if len(survey.images) else None
    psf_stamps = (
        None if stamp0 is None
        else np.zeros((P, cap) + stamp0.shape, np.float32)
    )
    for p, ids in enumerate(groups):
        for s, img_id in enumerate(ids):
            im = survey.images[int(img_id)]
            pixels[p, s] = im.pixels
            wcs[p, s] = im.wcs.to_vector()
            valid[p, s] = True
            if psf_stamps is not None:
                psf_stamps[p, s] = im.psf_stamp
            for k in META_COLS:
                ints[k][p, s] = tab[k][img_id]
            for k in FLOAT_COLS:
                floats[k][p, s] = tab[k][img_id]
            index[int(img_id)] = (p, s)
    return PackedDataset(
        layout=layout,
        pixels=pixels,
        wcs=wcs,
        valid=valid,
        ints=ints,
        floats=floats,
        pack_band=np.array(group_band, np.int32),
        pack_camcol=np.array(group_camcol, np.int32),
        index=index,
        psf_stamps=psf_stamps,
    )


def pack_per_file(survey: Survey) -> PackedDataset:
    """Each image is its own 'file' (the paper's raw-FITS baseline)."""
    ids = np.arange(len(survey))
    groups = [np.array([i]) for i in ids]
    tab = survey.meta_table()
    return _emit(
        "per_file",
        groups,
        survey,
        [int(tab["band_id"][i]) for i in ids],
        [int(tab["camcol"][i]) for i in ids],
    )


def pack_unstructured(survey: Survey, pack_capacity: int = 64, seed: int = 0) -> PackedDataset:
    """Random assignment of images to containers (Fig. 9 top)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(len(survey))
    groups = [ids[i : i + pack_capacity] for i in range(0, len(ids), pack_capacity)]
    return _emit("unstructured", groups, survey, [-1] * len(groups), [-1] * len(groups))


def pack_structured(survey: Survey, pack_capacity: int = 64) -> PackedDataset:
    """One container family per (band, camcol) CCD (Fig. 9 bottom)."""
    tab = survey.meta_table()
    groups: List[np.ndarray] = []
    gband: List[int] = []
    gcamcol: List[int] = []
    for band in range(survey.config.n_bands):
        for camcol in range(survey.config.n_camcols):
            sel = np.where((tab["band_id"] == band) & (tab["camcol"] == camcol))[0]
            for i in range(0, len(sel), pack_capacity):
                groups.append(sel[i : i + pack_capacity])
                gband.append(band)
                gcamcol.append(camcol)
    return _emit("structured", groups, survey, gband, gcamcol)
