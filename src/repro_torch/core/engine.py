"""CoaddEngine: the paper's MapReduce coaddition job, end to end, in torch.

Counterpart of ``repro.core.engine`` for the weighted-mean main path.  All
six input-format strategies of Table 1 / Table 2 are planners:

  1. ``raw_fits``                  — per-file layout, no prefilter
  2. ``raw_fits_prefiltered``      — glob (band x camcol) prefilter (§4.1.1)
  3. ``unstructured_seq``          — random containers; all packs read (§4.1.2)
  4. ``structured_seq_prefiltered``— (band, camcol) containers, glob-pruned (§4.1.3)
  5. ``sql_unstructured``          — exact index selection, random containers (§4.1.4)
  6. ``sql_structured``            — exact index selection, structured containers

Each ``plan_<method>(query) -> CoaddPlan`` builds a (P, cap) slot gate on the
host; ``execute(plan)`` runs it against the device-resident layout in one
pass over the gated packs.  With ``use_kernel=True`` (the default) that pass
is ONE launch of the hand-written ``coadd_fused`` CUDA kernel, which loops
over every gated pack and slot inside the kernel; ``use_kernel=False`` is
the plain torch counterpart of the reference's XLA path (``map_batch`` then
``reduce_local`` per pack).  Sparse execution (default on) scans only the
packs the gate opens, padded to a power-of-two bucket, and reblocks the
per-file layout into dense super-packs at residency time.

Robust stacks (``reduce="clipped" | "median"``, DESIGN.md §11) run the same
scan as two or three passes: moments, (for the median) a binapprox
histogram, and a clip re-scan, with the between-pass arithmetic as plain
torch on the device.  With ``use_kernel=True`` each pass is one launch of
``coadd_moments``, ``coadd_hist`` or ``coadd_clip``.

PSF matching (``match_psf_sigma``, DESIGN.md §7) convolves every frame to
one common PSF width before the warp, with a per-slot kernel bank solved on
the host: measured-PSF homogenization kernels (`psf.homogenization_bank`)
when the survey carries stamps, the separable Gaussian bank
(`psf.matching_kernel_bank`) otherwise; ``measured_psf`` forces either.
With ``use_kernel=True`` a query first runs ONE ``psf_match`` launch, which
writes its scanned packs' matched pixels to a scratch that each of its
passes reads: 2, 3 or 4 launches a query.  It matches only the slots a
pass reads, and writes zeros for the rejected slots the culled passes skip
(`_query_scan`).  The plain path convolves the
whole resident layout once per (layout, PSF state) and caches the matched
copy (``matched_pixel_cache``, the default), or convolves pack by pack
inside every pass; both give the same bytes.

Bricks (DESIGN.md §9): the survey is tessellated into a fixed lattice of
``brick_npix``-pixel bricks (`BrickGrid`), and a per-(brick, band) coadd is
materialized once into the `BrickStore` (`materialize_bricks`, or inline on
a miss).  ``run(..., use_bricks=True)`` serves a brick-aligned query by
mosaicking its cached tiles in ONE ``mosaic_bricks`` launch (with
``use_kernel=True``), bitwise equal to ``run_window``, the fresh scan of the
same lattice window; an unaligned query falls back to the ordinary path.

Batches (paper Fig. 5): ``run_batch``/``execute_batch`` run K same-layout
plans as one pass a pass over the union of their packs: with
``use_kernel=True`` each pass is ONE launch of a query-axis kernel
(``coadd_fused_batch``, ``coadd_moments_batch``, ``coadd_hist_batch``,
``coadd_clip_batch``) for all K queries, after one ``psf_match`` launch when
PSF-matched, and each query's result is bitwise its own ``run`` wherever
the union adds only finite slots (`result_key`).

Streaming residency (DESIGN.md §6): with ``device_budget_bytes`` set, no
layout is uploaded whole.  A query's gated packs are partitioned into
residency-chunk windows (`plan.window_schedule`, chunks of half the budget);
each window is scanned against its chunk while the next chunk uploads from
page-locked host memory on a side CUDA stream, the `ResidencyManager` evicts
cold chunks (and brick tiles) under the budget, and the window partials sum
on the device until the query's one host sync (`_sync`).  Under a PSF
bank the chunk is the matched-pixel cache: one ungated ``psf_match`` launch
over the chunk right after its upload, reused by repeat queries.  The fault
domain (journals, retries, quarantine) is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mapper, psf, reducer
from repro_torch.core.bricks import BrickCover, BrickGrid
from repro_torch.core.jobtracker import BrickTask, MaterializeReport, MaterializeTracker
from repro_torch.core.plan import (
    CoaddPlan,
    ScanWindow,
    SparseScanIndex,
    compact_gate,
    compact_gates,
    compact_window_gate,
    compact_window_gates,
    sparse_pack_index,
    stack_plans,
    union_sparse_index,
    window_schedule,
)
from repro_torch.core.prefilter import (
    SpatialIndex,
    camcol_dec_table,
    glob_file_mask,
    glob_pack_mask,
)
from repro_torch.core.query import CoaddQuery
from repro_torch.core.seqfile import (
    COST_MATCHED_CHUNK,
    COST_RAW_CHUNK,
    BrickMeta,
    BrickStore,
    DevicePackedDataset,
    PackedDataset,
    ResidencyManager,
    SlotRemap,
    pack_per_file,
    pack_structured,
    pack_unstructured,
)
from repro_torch.core.survey import Survey
from repro_torch.kernels.warp import ops as warp_ops
from repro_torch.kernels.warp import ref as warp_ref

METHODS = (
    "raw_fits",
    "raw_fits_prefiltered",
    "unstructured_seq",
    "structured_seq_prefiltered",
    "sql_unstructured",
    "sql_structured",
)


@dataclasses.dataclass
class JobStats:
    method: str
    files_considered: int          # mapper input records (Table 2)
    files_contributing: int        # actual coverage
    packs_touched: int             # planning-layout containers the gate opens
    t_locate_s: float              # job-init: prefilter/index ("RPC")
    t_map_reduce_s: float          # device pass, to results on the host
    t_total_s: float
    dispatches: int = 1            # kernel launches: one per pass, plus one
                                   #   psf_match when matching; on the plain
                                   #   path one map+reduce step per scanned
                                   #   pack and pass
    packs_gated: int = 0           # execution-layout packs the gate opens
    packs_scanned: int = 0         # packs the pass actually visits
    scan_budget: int = 0           # bucket the pass covers (n_packs if dense)
    reduce: str = "mean"           # estimator: "mean" | "clipped" | "median"
    reduce_passes: int = 1         # passes over the gated packs: 1, 2 or 3
    # Streaming residency (DESIGN.md §6), under a device budget: windows
    # scanned (every pass's), chunks uploaded and found resident, LRU
    # evictions this call forced; and the engine's device high-water mark
    # (`CoaddEngine._peak_resident_bytes`), set on every path.
    windows: int = 0
    chunk_uploads: int = 0
    residency_hits: int = 0
    residency_evictions: int = 0
    peak_resident_bytes: int = 0
    # Matched-pixel cache (DESIGN.md §7): PSF-matched copies this call
    # built (whole layouts on the plain path, chunks under a budget), and
    # those it found resident.
    matched_cache_builds: int = 0
    matched_cache_hits: int = 0
    # Brick serving (DESIGN.md §9), `run(use_bricks=True)`: tiles served
    # from the device tier, re-uploaded from the host tier, and materialized
    # inline, and the scan work those misses paid (0 on the warm path).
    bricks_hit: int = 0
    bricks_missed: int = 0
    bricks_spilled: int = 0
    residual_packs_scanned: int = 0
    # Coverage a quarantine removed (DESIGN.md §8).  The port has no
    # quarantine yet: always False / (), carried through `BrickMeta`.
    partial: bool = False
    uncovered_packs: Tuple[int, ...] = ()
    # `execute_batch`: a digest of the batch's pack index when it scans packs
    # this query's own run does not and some of their slots lack the finite
    # flag (so a rejected NaN may reach this result); "" when the result is
    # bitwise its own run's.  `CoaddEngine.result_key` joins it to the key.
    batch_scan: str = ""


@dataclasses.dataclass
class CoaddResult:
    coadd: np.ndarray
    depth: np.ndarray
    stats: JobStats

    @property
    def normalized(self) -> np.ndarray:
        # Exact masking, no epsilon clamp (see reducer.normalize).
        return np.where(
            self.depth > 0, self.coadd / np.where(self.depth > 0, self.depth, 1.0), 0.0
        )


def _query_vec(query: CoaddQuery) -> np.ndarray:
    t0, t1 = query.time_window()
    # Large-but-finite sentinels keep the vector finite.
    t0 = max(t0, -1e30)
    t1 = min(t1, 1e30)
    return np.array(
        [
            float(query.band_id),
            query.ra_bounds[0],
            query.ra_bounds[1],
            query.dec_bounds[0],
            query.dec_bounds[1],
            t0,
            t1,
        ],
        np.float32,
    )


def _brick_meta(stats: JobStats) -> BrickMeta:
    """The provenance a brick materialized by one query carries."""
    return BrickMeta(partial=stats.partial, uncovered_packs=stats.uncovered_packs,
                     files_considered=stats.files_considered,
                     files_contributing=stats.files_contributing)


def _mosaic_bricks(tiles, covs, offsets, npix: int, use_kernel: bool):
    """Merge (B, b, b) device brick tiles into one (npix, npix) coadd + depth:
    ONE ``mosaic_bricks`` launch with ``use_kernel``, else its plain version.
    Both accumulate into a zero canvas in brick order, so both match the
    fresh lattice-window scan bitwise."""
    if use_kernel:
        return warp_ops.mosaic_bricks(tiles, covs, offsets, npix)
    return reducer.mosaic_tiles(tiles, covs, offsets, npix)


def _accept_from_meta(ints, floats, qvec):
    """Algorithm-2 acceptance on (..., cap) metadata: band, valid, box, time.

    ``qvec`` is one query's (7,) vector, or a batch's (K, 7), broadcast over
    the metadata's axes to a (K, ..., cap) accept.
    """
    meta = ints["band_id"].dim()
    q = qvec.reshape(tuple(qvec.shape[:-1]) + (1,) * meta + (7,)).unbind(-1)
    band_ok = ints["band_id"].to(torch.float32) == q[0]
    valid = ints["image_id"] >= 0
    ra_ok = (floats["ra_max"] >= q[1]) & (floats["ra_min"] <= q[2])
    dec_ok = (floats["dec_max"] >= q[3]) & (floats["dec_min"] <= q[4])
    t_ok = (floats["t_obs"] >= q[5]) & (floats["t_obs"] <= q[6])
    return band_ok & valid & ra_ok & dec_ok & t_ok


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device`` without a host sync: on a CUDA
    device a pinned staging copy, then a copy on the current stream that
    does not block (a copy from pageable memory would wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _sync(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The streaming executors' ONE host sync, at reduce time (DESIGN.md §6)
    -> the tensors on the host, as numpy arrays.

    Every window dispatch and chunk upload before it is asynchronous: the
    device scans window N while chunk N+1 uploads behind it.  On a CUDA
    device each tensor is copied into pinned host memory on the current
    stream, which then is waited on once.  Tests monkeypatch this to pin
    the one-sync contract.
    """
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


def _query_scan(dev: DevicePackedDataset, idx: torch.Tensor, accept: torch.Tensor,
                grid_ra, grid_dec, use_kernel: bool, psf_kernels=None, host_idx=None):
    """The operands every pass of a query scans -> (scan, bank left to apply,
    slot flag, host copy of the scan's pack index).

    With a bank on the kernel path, ONE ``psf_match`` launch writes the
    scanned packs' matched pixels to a (G, cap, H, W) scratch, and every
    pass reads that (`ops.matched_packs`, its flag `ops.matched_finite`); on
    the plain path the bank rides into each plain scan, which matches pack
    by pack.  The flag lets the kernels skip rejected slots, and the
    pre-pass writes those as zeros without matching them: the same bits in
    every pass.  A batch's (K, G, cap) ``accept`` shares one pre-pass, which
    skips only the slots every query rejects.  ``host_idx`` is the numpy
    array ``idx`` was uploaded from: the wrappers check the index on it.
    """
    pixels, wcs, finite = dev.pixels, dev.wcs, dev.finite
    if use_kernel and psf_kernels is not None:
        finite = warp_ops.matched_finite(finite, idx, psf_kernels)
        pixels, wcs, idx = warp_ops.matched_packs(pixels, wcs, idx, psf_kernels, accept, finite,
                                                  host_idx=host_idx)
        host_idx = np.arange(idx.shape[0], dtype=np.int32)
        psf_kernels = None
    scan = (pixels, wcs, idx, accept.to(torch.float32), grid_ra, grid_dec)
    return scan, psf_kernels, finite, host_idx


#: Each pass's kernel wrapper (`warp_ops`) and plain version (`warp_ref`).
_PASS_FNS = {"fused": ("coadd_fused", "coadd_scan"), "moments": ("coadd_moments", "moments_scan"),
             "hist": ("coadd_hist", "hist_scan"), "clip": ("coadd_clip", "clip_scan")}


def _pass_fns(batch: bool, use_kernel: bool, finite=None, host_idx=None, bank=None):
    """The pass functions over one scan, by `_PASS_FNS` name.

    With ``use_kernel`` each is ONE launch of its CUDA kernel (the wrapper,
    given the slot flag and the pack index's host copy); otherwise the
    kernel's plain version, which maps and reduces pack by pack, applying
    ``bank`` pack by pack.  ``batch``: the query-axis forms.
    """
    sfx = "_batch" if batch else ""
    if use_kernel:
        return {p: functools.partial(getattr(warp_ops, k + sfx), finite=finite, host_idx=host_idx)
                for p, (k, _) in _PASS_FNS.items()}
    return {p: functools.partial(getattr(warp_ref, f"{r}{sfx}_ref"), psf_kernels=bank)
            for p, (_, r) in _PASS_FNS.items()}


def _estimate(reduce: str, clip_k: float, median_bins: int, run_pass):
    """An estimator's passes -> (passes, (coadd, depth)).

    ``run_pass(name, *fixed)`` runs the pass ``name`` (`_PASS_FNS`) with
    its fixed operands.  The mean is one fused pass.  A robust estimator
    runs moments; then, for the median, the histogram bounds, the histogram
    pass and its median; then the clip radius and the clip pass.  Centre,
    radius and bounds are fixed (Q, Q) operands ((K, Q, Q) for a batch)
    computed between passes in plain torch on the device, as the reference
    computes them in XLA outside its Pallas kernels.
    """
    if reduce == "mean":
        return 1, run_pass("fused")
    s0, s1, s2 = run_pass("moments")
    mu, sigma = reducer.clip_stats(s0, s1, s2)
    if reduce == "median":
        lo, w, inv_w = reducer.hist_bounds(s0, s1, s2, median_bins)
        center = reducer.hist_median(run_pass("hist", lo, inv_w, median_bins), s0, lo, w)
    else:
        center = mu
    return (3 if reduce == "median" else 2,
            run_pass("clip", center, reducer.clip_threshold(center, sigma, clip_k)))


@dataclasses.dataclass
class _Chunk:
    """A resident pack chunk under a device budget: its dataset, the bank
    slice every plain scan of it applies (the plain path without the
    matched cache), or the bank slice still to match it with, once, before
    its first scan (a matched chunk)."""

    dev: DevicePackedDataset
    bank: Optional[torch.Tensor] = None
    match: Optional[torch.Tensor] = None


class CoaddEngine:
    """Plans queries on the host, executes them against resident layouts.

    Pixels cross host->device once per layout (`device_dataset`); every
    query is one pass over the gated packs — one ``coadd_fused`` launch with
    ``use_kernel=True`` — or, for a robust estimator, two or three passes.
    ``clip_k`` is the sigma-clip radius and ``median_bins`` the binapprox
    histogram's resolution.  ``match_psf_sigma`` convolves every frame to
    that PSF width before the warp (one more launch a query on the kernel
    path); ``measured_psf`` picks the bank (None: measured stamps when the
    survey has them, True: stamps or raise, False: the Gaussian fallback)
    and ``matched_pixel_cache`` whether the plain path convolves each layout
    once and caches it.  ``brick_deg`` and ``brick_npix`` size the brick
    lattice (DESIGN.md §9).  ``device_budget_bytes`` turns on streaming
    residency (DESIGN.md §6): layouts stream through chunks of half the
    budget.  ``device`` defaults to ``"cuda"``; constructing an engine for
    a CUDA device on a machine without one raises.
    """

    def __init__(
        self,
        survey: Survey,
        pack_capacity: int = 64,
        use_kernel: bool = True,
        sparse: bool = True,
        device="cuda",
        match_psf_sigma: Optional[float] = None,
        measured_psf: Optional[bool] = None,
        matched_pixel_cache: bool = True,
        device_budget_bytes: Optional[int] = None,
        clip_k: float = 3.0,
        median_bins: int = 16,
        brick_deg: float = 0.25,
        brick_npix: int = 64,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CoaddEngine needs a CUDA device and none is available; "
                "pass device='cpu' to run the plain torch path"
            )
        if use_kernel and int(median_bins) not in warp_ops.HIST_BINS:
            raise ValueError(f"median_bins must be one of {warp_ops.HIST_BINS} with "
                             f"use_kernel=True (the coadd_hist kernel's builds), "
                             f"got {median_bins}")
        self.survey = survey
        self.clip_k = float(clip_k)
        self.median_bins = int(median_bins)
        self.use_kernel = use_kernel
        self.sparse = sparse
        # PSF state (DESIGN.md §7); both knobs may be retuned on a live
        # engine: every bank and matched copy is keyed by `_psf_state`.
        self.match_psf_sigma = match_psf_sigma
        self.measured_psf = measured_psf
        self.matched_pixel_cache = matched_pixel_cache
        # Streaming residency (DESIGN.md §6): with a budget no layout is
        # uploaded whole; chunks stream in on a side stream (made at first use).
        self.device_budget_bytes = device_budget_bytes
        self._copy_stream = None
        self.camcol_dec = camcol_dec_table(survey)
        self.sql = SpatialIndex.build(survey)
        self._datasets: Dict[str, PackedDataset] = {}
        self._exec_cache: Dict[str, Tuple[PackedDataset, Optional[SlotRemap]]] = {}
        self._device_cache: Dict[str, DevicePackedDataset] = {}
        self._psf_banks: Dict[Tuple, np.ndarray] = {}
        self._psf_device: Dict[Tuple, torch.Tensor] = {}
        self._matched_cache: Dict[Tuple, DevicePackedDataset] = {}
        self._pack_capacity = pack_capacity
        self.pack_upload_count = 0   # host->device uploads of whole layouts or
                                     #   streamed chunks
        self.dispatch_count = 0      # executed passes over the gated packs (a
                                     #   streamed pass counts each window), plus
                                     #   each psf_match pre-pass; a batch counts
                                     #   as one query
        self.matched_builds = 0      # matched copies built: whole layouts (plain
                                     #   path), or matched chunks under a budget
        # Brick tessellation (DESIGN.md §9): the grid is built lazily from the
        # survey footprint; the store's device tier lives in the engine's
        # ResidencyManager, so under a budget brick tiles compete with pack
        # chunks (at COST_BRICK) and spill back to their host copy.
        self.brick_deg = brick_deg
        self.brick_npix = brick_npix
        self._brick_grid: Optional[BrickGrid] = None
        self.residency = ResidencyManager(device_budget_bytes)
        self.residency.on_evict = self._chunk_evicted
        self.brick_store = BrickStore(self.residency, self.device)

    # ----- dataset layouts (built lazily, cached) -----
    def dataset(self, layout: str) -> PackedDataset:
        if layout not in self._datasets:
            if layout == "per_file":
                self._datasets[layout] = pack_per_file(self.survey)
            elif layout == "unstructured":
                self._datasets[layout] = pack_unstructured(
                    self.survey, self._pack_capacity
                )
            elif layout == "structured":
                self._datasets[layout] = pack_structured(
                    self.survey, self._pack_capacity
                )
            else:
                raise ValueError(layout)
        return self._datasets[layout]

    def exec_dataset(self, layout: str) -> Tuple[PackedDataset, Optional[SlotRemap]]:
        """Execution-side form of a layout + the gate remap onto it.

        Planning sees the layout as the method defines it; under sparse
        execution the per-file layout (P=N, cap=1) is reblocked into dense
        ``pack_capacity``-slot super-packs and gates are rewritten through
        the returned `SlotRemap`.
        """
        if layout not in self._exec_cache:
            ds = self.dataset(layout)
            if self.sparse and layout == "per_file" and ds.capacity < self._pack_capacity:
                self._exec_cache[layout] = ds.reblock(self._pack_capacity)
            else:
                self._exec_cache[layout] = (ds, None)
        return self._exec_cache[layout]

    def device_dataset(self, layout: str) -> DevicePackedDataset:
        """Device-resident form of a layout; uploaded once, then cached."""
        if layout not in self._device_cache:
            exec_ds, _ = self.exec_dataset(layout)
            self._device_cache[layout] = exec_ds.to_device(self.device)
            self.pack_upload_count += 1
        return self._device_cache[layout]

    @property
    def resident_bytes(self) -> int:
        """Device bytes of every resident layout, kernel bank, matched copy
        (only its pixels: it shares the layout's WCS and metadata), streamed
        chunk and brick tile (the residency manager's entries)."""
        return self._eager_resident_bytes() + self.residency.bytes_resident

    # ----- PSF matching: banks solved on the host, cached per PSF state -----
    def _psf_state(self) -> Optional[Tuple]:
        """Hashable id of the PSF configuration every bank and matched copy
        derives from: (target, measured mode), or None when matching is off.
        Retuning either knob misses every cache instead of reusing it."""
        if self.match_psf_sigma is None:
            return None
        return (float(self.match_psf_sigma), self.measured_psf)

    def psf_kernel_bank(self, layout: str) -> Optional[np.ndarray]:
        """Per-slot matching kernels on the host, or None when matching is off.

        (P, cap, S, S) homogenization kernels when the layout carries
        measured stamps, the separable (P, cap, K) Gaussian bank otherwise
        (``measured_psf`` forces either).  Built against the *execution*
        form, so a reblocked per-file layout lines up slot for slot.
        """
        if self.match_psf_sigma is None:
            return None
        key = (layout, self._psf_state())
        if key not in self._psf_banks:
            for k in [k for k in self._psf_banks if k[0] == layout]:
                del self._psf_banks[k]   # one host bank per layout
            exec_ds, _ = self.exec_dataset(layout)
            measured = (self.measured_psf if self.measured_psf is not None
                        else exec_ds.psf_stamps is not None)
            if measured:
                if exec_ds.psf_stamps is None:
                    raise ValueError("measured_psf=True but the survey carries no PSF "
                                     "stamps (SurveyConfig.psf_stamps)")
                self._psf_banks[key] = psf.homogenization_bank(
                    exec_ds.psf_stamps, exec_ds.floats["psf_sigma"], self.match_psf_sigma)
            else:
                self._psf_banks[key] = psf.matching_kernel_bank(
                    exec_ds.floats["psf_sigma"], self.match_psf_sigma)
        return self._psf_banks[key]

    def _device_psf_kernels(self, layout: str) -> Optional[torch.Tensor]:
        """The layout's bank on the device; uploaded once per PSF state."""
        bank = self.psf_kernel_bank(layout)
        if bank is None:
            return None
        key = (layout, self._psf_state())
        if key not in self._psf_device:
            for k in [k for k in self._psf_device if k[0] == layout]:
                del self._psf_device[k]  # one device bank per layout
            self._psf_device[key] = torch.from_numpy(bank).to(self.device)
        return self._psf_device[key]

    def _matched_mode(self) -> bool:
        """Whether passes read a cached whole-layout matched copy: the plain
        path only.  The kernel path matches the scanned packs once per query
        (one ``psf_match`` launch) instead of holding a second layout."""
        return (self.match_psf_sigma is not None and not self.use_kernel
                and self.matched_pixel_cache)

    def _matched_device_dataset(self, layout: str,
                                dev: DevicePackedDataset) -> Tuple[DevicePackedDataset, int]:
        """The resident layout with its pixels PSF-matched -> (dataset, hits).

        Built once per (layout, PSF state) on the device, pack by pack with
        `psf.convolve_batch` (the operations a plain pass applies when it
        matches per query, so cached and uncached results are the same
        bytes), and kept; the previous state's copy of the layout is
        dropped.  WCS and metadata are the layout's own tensors.
        """
        key = (layout, self._psf_state())
        for k in [k for k in self._matched_cache if k[0] == layout and k != key]:
            del self._matched_cache[k]
        if key in self._matched_cache:
            return self._matched_cache[key], 1
        bank = self._device_psf_kernels(layout)
        pixels = torch.empty_like(dev.pixels)
        for p in range(dev.n_packs):
            pixels[p] = psf.convolve_batch(dev.pixels[p], bank[p])
        self.matched_builds += 1
        self._matched_cache[key] = DevicePackedDataset(pixels=pixels, wcs=dev.wcs,
                                                       ints=dev.ints, floats=dev.floats)
        return self._matched_cache[key], 0

    def _check_plan_psf(self, plan: CoaddPlan) -> None:
        """A plan built under one PSF target must not run under another."""
        if plan.psf_target != self.match_psf_sigma:
            raise ValueError(
                f"plan was built with psf_target={plan.psf_target} but this engine "
                f"matches to {self.match_psf_sigma}; re-plan on the engine that will execute"
            )

    def _grids(self, query: CoaddQuery):
        return tuple(_upload(a, self.device) for a in mapper.query_grid_sky(query))

    def _plan_grids(self, plan: CoaddPlan):
        """The plan's output grid: its `grid_sky` override (brick-lattice
        plans, DESIGN.md §9) when present, the query's own TAN grid otherwise."""
        if plan.grid_sky is not None:
            return tuple(_upload(a, self.device) for a in plan.grid_sky)
        return self._grids(plan.query)

    # ----- planning: the six methods differ ONLY in gate construction -----
    def plan(self, query: CoaddQuery, method: str, reduce: str = "mean") -> CoaddPlan:
        if method not in METHODS:
            raise ValueError(f"unknown method {method}; expected one of {METHODS}")
        if reduce not in reducer.REDUCERS:
            raise ValueError(f"unknown reduce {reduce!r}; expected one of {reducer.REDUCERS}")
        plan = getattr(self, f"plan_{method}")(query)
        # Set after the method planner, so all six stay estimator-agnostic.
        plan.reduce = reduce
        return plan

    def plan_raw_fits(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("per_file")
        t0 = time.perf_counter()
        # No prefilter: every file is "located" and becomes a mapper input.
        gate = ds.valid.copy()
        t_locate = time.perf_counter() - t0
        return CoaddPlan("raw_fits", "per_file", gate, _query_vec(query), query, t_locate,
                         psf_target=self.match_psf_sigma)

    def plan_raw_fits_prefiltered(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("per_file")
        t0 = time.perf_counter()
        mask = glob_file_mask(self.survey.meta_table(), query, self.camcol_dec)
        gate = ds.valid & mask[:, None]  # per-file layout: pack == file
        t_locate = time.perf_counter() - t0
        return CoaddPlan("raw_fits_prefiltered", "per_file", gate,
                         _query_vec(query), query, t_locate, psf_target=self.match_psf_sigma)

    def plan_unstructured_seq(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("unstructured")
        t0 = time.perf_counter()
        gate = ds.valid.copy()  # unprunable by construction: read every pack
        t_locate = time.perf_counter() - t0
        return CoaddPlan("unstructured_seq", "unstructured", gate,
                         _query_vec(query), query, t_locate, psf_target=self.match_psf_sigma)

    def plan_structured_seq_prefiltered(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("structured")
        t0 = time.perf_counter()
        mask = glob_pack_mask(ds, query, self.camcol_dec)
        gate = ds.valid & mask[:, None]
        t_locate = time.perf_counter() - t0
        return CoaddPlan("structured_seq_prefiltered", "structured", gate,
                         _query_vec(query), query, t_locate, psf_target=self.match_psf_sigma)

    def _plan_sql(self, layout: str, query: CoaddQuery, method: str) -> CoaddPlan:
        ds = self.dataset(layout)
        t0 = time.perf_counter()
        ids = self.sql.select(query)
        # The index maps ids -> (pack, slot): exact selection is a
        # metadata-only slot gate over the resident containers.
        gate = ds.slot_mask(ids)
        t_locate = time.perf_counter() - t0
        return CoaddPlan(method, layout, gate, _query_vec(query), query, t_locate,
                         psf_target=self.match_psf_sigma)

    def plan_sql_unstructured(self, query: CoaddQuery) -> CoaddPlan:
        return self._plan_sql("unstructured", query, "sql_unstructured")

    def plan_sql_structured(self, query: CoaddQuery) -> CoaddPlan:
        return self._plan_sql("structured", query, "sql_structured")

    def _exec_gate(self, plan: CoaddPlan) -> np.ndarray:
        """A plan's gate in execution-layout coordinates (remapped if reblocked)."""
        _, remap = self.exec_dataset(plan.layout)
        return remap.apply(plan.gate) if remap is not None else plan.gate

    def _sparse_index(self, gate_or_gates: np.ndarray) -> Optional[SparseScanIndex]:
        """The gather plan for a (P, cap) gate, or a batch's (K, P, cap) stack
        (the union of their packs), or None for the dense scan.

        Sparse execution pays only when the bucket is smaller than the
        layout; a full-archive gate scans densely.
        """
        if not self.sparse:
            return None
        sp = (union_sparse_index(gate_or_gates) if gate_or_gates.ndim == 3
              else sparse_pack_index(gate_or_gates))
        return sp if sp.worthwhile else None

    # ----- execution: one pass against resident data -----
    def _scan_index(self, layout: str, gate: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """An execution-layout gate -> the (G,) int32 pack index its pass
        scans (``arange(P)`` when dense) and the (G, cap) gate over those
        packs; a batch's (K, P, cap) gates -> the union's index and (K, G,
        cap) gates.  Host numpy."""
        sp = self._sparse_index(gate)
        if sp is None:
            return np.arange(self.exec_dataset(layout)[0].n_packs, dtype=np.int32), gate
        return sp.pack_idx, (compact_gates(gate, sp) if gate.ndim == 3 else compact_gate(gate, sp))

    def _accept(self, dev: DevicePackedDataset, idx: torch.Tensor, scan_gate: np.ndarray,
                qvec: np.ndarray) -> torch.Tensor:
        """The (G, cap) bool slots a pass over ``idx`` of ``dev`` accumulates
        ((K, G, cap) for a batch's gates and (K, 7) vectors): acceptance as
        plain torch ops on the gathered metadata (in the reference it is XLA
        outside the Pallas kernel), ANDed with the gate."""
        rows = idx.to(torch.int64)
        return _accept_from_meta(
            {k: v[rows] for k, v in dev.ints.items()},
            {k: v[rows] for k, v in dev.floats.items()},
            _upload(qvec, self.device),
        ) & _upload(scan_gate, self.device)

    def _operands(self, layout: str, gate: np.ndarray, qvec: np.ndarray):
        """A pass's operands for an execution-layout gate and query vector:
        the resident layout, the pack index on the device and the accepted
        slots (`_scan_index`, `_accept`)."""
        dev = self.device_dataset(layout)
        pack_idx, scan_gate = self._scan_index(layout, gate)
        idx = _upload(pack_idx, self.device)
        return dev, idx, self._accept(dev, idx, scan_gate, qvec)

    def _scan_operands(self, plan: CoaddPlan):
        """The pass's operands for a plan: (resident layout, (G,) pack index,
        (G, cap) accepted slots), as `_operands`."""
        return self._operands(plan.layout, self._exec_gate(plan), plan.qvec)

    def execute(self, plan: CoaddPlan) -> CoaddResult:
        """Run a plan: device-resident packs + (P, cap) slot gate.  Under a
        device budget the query streams instead (`_execute_streaming`)."""
        self._check_plan_psf(plan)
        if self.device_budget_bytes is not None:
            return self._execute_streaming(plan)
        # The one upload, the bank and a matched copy stay out of the timing.
        dev = self.device_dataset(plan.layout)
        bank = self._device_psf_kernels(plan.layout)
        m_builds0, m_hits = self.matched_builds, 0
        if self._matched_mode():
            dev, m_hits = self._matched_device_dataset(plan.layout, dev)
            bank = None
        grid_ra, grid_dec = self._plan_grids(plan)
        t1 = time.perf_counter()
        gate = self._exec_gate(plan)
        pack_idx, scan_gate = self._scan_index(plan.layout, gate)
        idx = _upload(pack_idx, self.device)
        accept = self._accept(dev, idx, scan_gate, plan.qvec)
        passes, (coadd, depth) = self._passes(dev, idx, accept, grid_ra, grid_dec, plan.reduce,
                                              bank, pack_idx)
        contrib = int(accept.sum())
        coadd_h, depth_h = coadd.cpu().numpy(), depth.cpu().numpy()
        t2 = time.perf_counter()
        n_scanned = idx.shape[0]
        return CoaddResult(
            coadd_h,
            depth_h,
            JobStats(
                method=plan.method,
                files_considered=int(gate.sum()),
                files_contributing=contrib,
                packs_touched=plan.packs_touched,
                t_locate_s=plan.t_locate_s,
                t_map_reduce_s=t2 - t1,
                t_total_s=plan.t_locate_s + (t2 - t1),
                dispatches=(passes + (bank is not None) if self.use_kernel
                            else passes * n_scanned),
                packs_gated=int(gate.any(axis=1).sum()),
                packs_scanned=n_scanned,
                scan_budget=n_scanned,
                reduce=plan.reduce,
                reduce_passes=passes,
                matched_cache_builds=self.matched_builds - m_builds0,
                matched_cache_hits=m_hits,
                peak_resident_bytes=self._peak_resident_bytes(),
            ),
        )

    def _passes(self, dev, idx, accept, grid_ra, grid_dec, reduce: str, bank, host_idx):
        """The estimator's passes over ``idx`` (uploaded from ``host_idx``)
        -> (passes, (coadd, depth)): one query, or a batch's (K, G, cap)
        ``accept`` and (K, Q, Q) grids.  Each pass is one launch of its
        kernel with ``use_kernel`` (a bank first runs the one pre-pass,
        `_query_scan`), else its plain version.  Counts the passes, and the
        pre-pass a bank costs on the kernel path, in ``dispatch_count``: a
        batch counts as one query."""
        scan, left, finite, host_idx = _query_scan(dev, idx, accept, grid_ra, grid_dec,
                                                   self.use_kernel, bank, host_idx)
        fns = _pass_fns(accept.dim() == 3, self.use_kernel, finite, host_idx, left)
        passes, out = _estimate(reduce, self.clip_k, self.median_bins,
                                lambda name, *fixed: fns[name](*scan, *fixed))
        self.dispatch_count += passes + (self.use_kernel and bank is not None)
        return passes, out

    def result_key(self, plan: CoaddPlan, result: Optional[CoaddResult] = None) -> str:
        """Serving-cache identity of one plan's result (DESIGN.md §10).

        The plan's value fingerprint (`CoaddPlan.fingerprint`) joined with the
        engine state that also determines the pixels: the live PSF state, the
        program family (kernel or plain path, sparse gather, the streaming
        partition; their sums differ in order) and, for a robust plan, the
        clip radius and bin count.  Contract: equal keys => bitwise-equal coadds.  Given a
        ``result`` of `execute_batch` that may differ from the plan's own run
        (`JobStats.batch_scan`), the digest of that batch's scan joins the
        key, so the result never answers for the plan's own run.
        """
        key = (f"{plan.fingerprint}|{self._psf_state()}"
               f"|k{int(self.use_kernel)}|s{int(self.sparse)}|b{self.device_budget_bytes}")
        if plan.reduce != "mean":
            key += f"|ck{self.clip_k}|mb{self.median_bins}"
        if result is not None and result.stats.batch_scan:
            key += f"|x{result.stats.batch_scan}"
        return key

    def run(self, query: CoaddQuery, method: str, use_bricks: bool = False,
            reduce: str = "mean") -> CoaddResult:
        """Plan + execute one query; ``reduce`` picks the estimator (DESIGN.md §11):
        "mean", "clipped" (k-sigma-clipped mean) or "median" (binapprox
        median, then a clip about it).

        With ``use_bricks=True`` (DESIGN.md §9) a brick-aligned query is
        served by mosaicking cached brick coadds, materializing any missing
        brick inline; an unaligned query falls back to the ordinary path
        (its stats carry zero brick counters).  Bricks are cached per
        estimator and PSF state.
        """
        if use_bricks:
            res = self._run_bricks(query, method, reduce)
            if res is not None:
                return res
        return self.execute(self.plan(query, method, reduce))

    # ----- brick-tessellated materialized coadds (DESIGN.md §9) -----
    @property
    def brick_grid(self) -> BrickGrid:
        """The survey's brick tessellation (built lazily, fixed per engine)."""
        if self._brick_grid is None:
            self._brick_grid = BrickGrid.for_survey(self.survey.config, self.brick_deg,
                                                    self.brick_npix)
        return self._brick_grid

    def _brick_key(self, band: str, row: int, col: int, reduce: str = "mean") -> Tuple:
        """BrickStore identity of one materialized (brick, band) cell.

        Carries `_psf_state()`, so a retuned engine misses and re-materializes
        instead of mosaicking tiles matched to another target; a robust
        estimator extends the key with its knobs (retuning clip_k or the bin
        count must miss).  The key shapes are the reference's.
        """
        key = ("brick", band, row, col, self._psf_state())
        if reduce != "mean":
            key += (reduce, self.clip_k, self.median_bins)
        return key

    def _brick_plan(self, band: str, row: int, col: int, method: str,
                    reduce: str = "mean") -> CoaddPlan:
        """The materialization plan for one brick: a normal planned query
        whose output grid is overridden onto the global lattice tile."""
        plan = self.plan(self.brick_grid.brick_query(row, col, band), method, reduce)
        plan.grid_sky = self.brick_grid.brick_sky(row, col)
        return plan

    def warm_brick_cover(self, query: CoaddQuery,
                         reduce: str = "mean") -> Optional[BrickCover]:
        """This query's brick cover iff *every* covered tile is stored, else
        None (unaligned, or some tile cold): a caller that routes only such
        queries to `run(use_bricks=True)` never materializes inline."""
        cover = self.brick_grid.decompose(query)
        if cover is None:
            return None
        if all(self.brick_store.contains(self._brick_key(query.band, r, c, reduce))
               for r, c in cover.bricks):
            return cover
        return None

    def run_window(self, query: CoaddQuery, method: str,
                   reduce: str = "mean") -> CoaddResult:
        """The brick-free baseline for a brick-aligned query: one fresh scan
        onto the lattice-window grid, no bricks consulted.  This is what
        `run(use_bricks=True)` must match bitwise.  Raises on queries that do
        not decompose (use plain `run` for those)."""
        cover = self.brick_grid.decompose(query)
        if cover is None:
            raise ValueError("query is not brick-aligned; run_window only serves "
                             "lattice-window queries (see BrickGrid.window_query)")
        plan = self.plan(query, method, reduce)
        plan.grid_sky = self.brick_grid.window_sky(cover.r0, cover.r1, cover.c0, cover.c1)
        return self.execute(plan)

    def _run_bricks(self, query: CoaddQuery, method: str,
                    reduce: str = "mean") -> Optional[CoaddResult]:
        """Serve a brick-aligned query from the BrickStore, or None.

        Fetches every covered tile (device tier first, a host-tier re-upload
        otherwise), materializes the misses inline (each a normal `execute`,
        stored for the next query), and merges the tiles in one mosaic
        launch.  The stats sum the misses' scan work, as far as the port's
        `JobStats` carries it.
        """
        cover = self.brick_grid.decompose(query)
        if cover is None:
            return None
        t0 = time.perf_counter()
        store = self.brick_store
        b = self.brick_npix
        hits = spills = 0
        tiles: List[Optional[torch.Tensor]] = []
        covs: List[Optional[torch.Tensor]] = []
        metas: List[Optional[BrickMeta]] = []
        offsets: List[Tuple[int, int]] = []
        missing: List[int] = []
        for i, (r, c) in enumerate(cover.bricks):
            offsets.append(((r - cover.r0) * b, (c - cover.c0) * b))
            got = store.fetch(self._brick_key(query.band, r, c, reduce))
            if got is None:
                missing.append(i)
                tiles.append(None)
                covs.append(None)
                metas.append(None)
                continue
            coadd_dev, depth_dev, meta, tier = got
            hits += tier == "device"
            spills += tier == "host"
            tiles.append(coadd_dev)
            covs.append(depth_dev)
            metas.append(meta)
        t_fetch = time.perf_counter() - t0
        # The residual: bricks nobody materialized yet, each one fresh scan
        # now, cached for every query after.
        residual = JobStats("", 0, 0, 0, 0.0, 0.0, 0.0, dispatches=0)
        for i in missing:
            r, c = cover.bricks[i]
            res = self.execute(self._brick_plan(query.band, r, c, method, reduce))
            metas[i] = _brick_meta(res.stats)
            tiles[i], covs[i] = store.put(self._brick_key(query.band, r, c, reduce),
                                          res.coadd, res.depth, metas[i])
            s = res.stats
            residual.t_locate_s += s.t_locate_s
            residual.t_map_reduce_s += s.t_map_reduce_s
            residual.dispatches += s.dispatches
            residual.packs_touched += s.packs_touched
            residual.packs_gated += s.packs_gated
            residual.packs_scanned += s.packs_scanned
            residual.scan_budget = max(residual.scan_budget, s.scan_budget)
            residual.matched_cache_builds += s.matched_cache_builds
            residual.matched_cache_hits += s.matched_cache_hits
            residual.reduce_passes = max(residual.reduce_passes, s.reduce_passes)
        t1 = time.perf_counter()
        self.dispatch_count += 1
        offsets_dev = torch.tensor(offsets, dtype=torch.int32).to(self.device)
        coadd, depth = _mosaic_bricks(torch.stack(tiles), torch.stack(covs), offsets_dev,
                                      query.npix, self.use_kernel)
        coadd_h, depth_h = coadd.cpu().numpy(), depth.cpu().numpy()
        t2 = time.perf_counter()
        return CoaddResult(
            coadd_h,
            depth_h,
            JobStats(
                method=method,
                files_considered=sum(m.files_considered for m in metas),
                files_contributing=sum(m.files_contributing for m in metas),
                packs_touched=residual.packs_touched,
                t_locate_s=t_fetch + residual.t_locate_s,
                t_map_reduce_s=residual.t_map_reduce_s + (t2 - t1),
                t_total_s=t2 - t0,
                dispatches=residual.dispatches + 1,
                packs_gated=residual.packs_gated,
                packs_scanned=residual.packs_scanned,
                scan_budget=residual.scan_budget,
                reduce=reduce,
                reduce_passes=residual.reduce_passes if missing else 1,
                matched_cache_builds=residual.matched_cache_builds,
                matched_cache_hits=residual.matched_cache_hits,
                bricks_hit=hits,
                bricks_missed=len(missing),
                bricks_spilled=spills,
                residual_packs_scanned=residual.packs_scanned,
                partial=any(m.partial for m in metas),
                uncovered_packs=tuple(sorted({p for m in metas for p in m.uncovered_packs})),
            ),
        )

    def materialize_bricks(
        self,
        bands: Sequence[str] = ("r",),
        region: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None,
        method: str = "sql_structured",
        reduce: str = "mean",
    ) -> MaterializeReport:
        """Materialize the (brick, band) lattice into the BrickStore.

        Every cell is one normal planned and executed brick query, journaled
        by its presence in the store: a job re-issued with the same arguments
        skips finished bricks.  ``region=(ra_bounds, dec_bounds)`` restricts
        it to the cells whose nominal box intersects the region.
        """
        cells = self.brick_grid.bricks(region)
        tasks = [BrickTask(band=band, row=r, col=c) for band in bands for (r, c) in cells]

        def is_done(task: BrickTask) -> bool:
            return self.brick_store.contains(
                self._brick_key(task.band, task.row, task.col, reduce))

        def run_one(task: BrickTask) -> None:
            res = self.execute(self._brick_plan(task.band, task.row, task.col, method, reduce))
            self.brick_store.put(self._brick_key(task.band, task.row, task.col, reduce),
                                 res.coadd, res.depth, _brick_meta(res.stats))
            task.status = "partial" if res.stats.partial else "done"
            task.packs_scanned = res.stats.packs_scanned

        return MaterializeReport(MaterializeTracker().run(tasks, is_done, run_one))

    # ----- batched multi-query jobs (paper Fig. 5) -----
    def run_batch(self, queries: Sequence[CoaddQuery], method: str,
                  reduce: str = "mean") -> List[CoaddResult]:
        """Plan + execute K same-method queries as one batch (`execute_batch`)."""
        queries = list(queries)
        if not queries:
            return []
        return self.execute_batch([self.plan(q, method, reduce) for q in queries])

    def execute_batch(self, plans: Sequence[CoaddPlan]) -> List[CoaddResult]:
        """K stacked plans -> one batched pass a pass -> per-query results.

        The plans must share a layout, npix and estimator (`stack_plans`).
        Sparse batches scan the union of their gates' packs
        (`union_sparse_index`), each query's compacted gate re-selecting its
        own slots; a union that is not worthwhile scans densely.  With
        ``use_kernel`` each pass is ONE launch of its batched kernel for all
        K queries, after one ``psf_match`` launch when PSF-matched: 1, 2 or
        3 launches, plus 1, whatever K is.  The one interval, the launches
        and the scanned packs go to the first result's stats.
        """
        plans = list(plans)
        for p in plans:
            self._check_plan_psf(p)
        gates, qvecs = stack_plans(plans)
        layout = plans[0].layout
        _, remap = self.exec_dataset(layout)
        if remap is not None:
            gates = np.stack([remap.apply(g) for g in gates])
        if self.device_budget_bytes is not None:
            return self._execute_batch_streaming(plans, gates, qvecs)
        # The one upload, the bank, a matched copy and the host grids stay
        # out of the timing, as in `execute`.
        dev = self.device_dataset(layout)
        bank = self._device_psf_kernels(layout)
        m_builds0, m_hits = self.matched_builds, 0
        if self._matched_mode():
            dev, m_hits = self._matched_device_dataset(layout, dev)
            bank = None
        grids = [self._plan_grids(p) for p in plans]
        grids_ra = torch.stack([g[0] for g in grids])
        grids_dec = torch.stack([g[1] for g in grids])
        t1 = time.perf_counter()
        pack_idx, scan_gates = self._scan_index(layout, gates)
        idx = _upload(pack_idx, self.device)
        accept = self._accept(dev, idx, scan_gates, qvecs)
        passes, (coadds, depths) = self._passes(dev, idx, accept, grids_ra, grids_dec,
                                                plans[0].reduce, bank, pack_idx)
        contribs = accept.sum(dim=(1, 2)).tolist()
        coadds_h, depths_h = coadds.cpu().numpy(), depths.cpu().numpy()
        t2 = time.perf_counter()
        n_scanned = idx.shape[0]
        scans = self._batch_scans(layout, gates, pack_idx)
        dispatches = passes + (bank is not None) if self.use_kernel else passes * n_scanned
        results = []
        for i, p in enumerate(plans):
            first = i == 0
            t_mr = (t2 - t1) if first else 0.0
            results.append(CoaddResult(
                coadds_h[i],
                depths_h[i],
                JobStats(
                    method=p.method,
                    files_considered=int(gates[i].sum()),
                    files_contributing=int(contribs[i]),
                    packs_touched=p.packs_touched,
                    t_locate_s=p.t_locate_s,
                    t_map_reduce_s=t_mr,
                    t_total_s=p.t_locate_s + t_mr,
                    dispatches=dispatches if first else 0,
                    packs_gated=int(gates[i].any(axis=1).sum()),
                    packs_scanned=n_scanned if first else 0,
                    scan_budget=n_scanned,
                    reduce=p.reduce,
                    reduce_passes=passes,
                    matched_cache_builds=(self.matched_builds - m_builds0) if first else 0,
                    matched_cache_hits=m_hits if first else 0,
                    peak_resident_bytes=self._peak_resident_bytes(),
                    batch_scan=scans[i],
                ),
            ))
        return results

    def _batch_scans(self, layout: str, gates: np.ndarray, batch_packs: np.ndarray) -> List[str]:
        """Per query of a batch: "" when the batch's scan is bitwise its own
        run's, else a digest of the batch's pack index (`JobStats.batch_scan`).

        The batch scans the union of the queries' packs.  A pack the query's
        own run does not scan holds only slots it rejects, and a rejected
        slot adds exact zeros while its pixels are finite and at most 2^62
        (the finite flag; over a PSF bank, `ops.matched_finite`'s).  A
        rejected NaN adds NaN, as it does in the reference's batches.
        ``batch_packs`` is the batch's (G,) pack index on the host.
        """
        digest = hashlib.sha256(batch_packs.tobytes()).hexdigest()[:16]
        n_packs = self.exec_dataset(layout)[0].n_packs
        flag = None
        out = []
        for gate in gates:
            sp = self._sparse_index(gate)
            own = np.arange(n_packs) if sp is None else sp.pack_idx
            extra = np.setdiff1d(batch_packs, own)
            if len(extra) and flag is None:
                flag = self._slot_flag(layout)
            out.append(digest if len(extra) and not flag[extra].all() else "")
        return out

    def _slot_flag(self, layout: str) -> np.ndarray:
        """(P, cap) bool: the slots from which a query that rejects them adds
        only exact zeros on this engine's passes (the culled passes' flag)."""
        dev = self.device_dataset(layout)
        flag = dev.finite
        bank = self._device_psf_kernels(layout)
        if bank is not None:
            every = torch.arange(dev.n_packs, dtype=torch.int32, device=flag.device)
            flag = warp_ops.matched_finite(flag, every, bank)
        return flag.cpu().numpy() != 0

    # ----- streaming residency (DESIGN.md §6) -----
    def _eager_resident_bytes(self) -> int:
        """Device bytes held outside the `ResidencyManager`: whole-layout
        uploads, kernel banks and the plain path's matched copies (only
        their pixels: they share the layout's WCS and metadata)."""
        return (sum(d.nbytes for d in self._device_cache.values())
                + sum(b.numel() * b.element_size() for b in self._psf_device.values())
                + sum(d.pixels.numel() * d.pixels.element_size()
                      for d in self._matched_cache.values()))

    def _peak_resident_bytes(self) -> int:
        """The `JobStats` high-water mark: the manager's peak (chunks, brick
        tiles, in-flight and transient bytes) plus the eager residents (none
        under a budget, where nothing is uploaded whole)."""
        return self.residency.peak_bytes + self._eager_resident_bytes()

    def _bank_pack_nbytes(self, layout: str) -> int:
        """Device bytes ONE pack's PSF bank adds (0 when matching is off),
        charged with the pixels so the budget bounds all a chunk holds."""
        bank = self.psf_kernel_bank(layout)
        return 0 if bank is None else int(bank[0].nbytes)

    def _chunk_packs(self, exec_ds: PackedDataset) -> int:
        """Packs per residency chunk: half the budget, so two chunks (the
        one being scanned and the one uploading behind it) fit together."""
        pack_bytes = max(exec_ds.pack_nbytes() + self._bank_pack_nbytes(exec_ds.layout), 1)
        return max(1, min(int(self.device_budget_bytes // (2 * pack_bytes)), exec_ds.n_packs))

    def _stream_matched(self) -> bool:
        """Whether a streamed chunk is matched once, on the device (the chunk
        is the matched-pixel cache): under a bank on the kernel path, and on
        the plain path with ``matched_pixel_cache``."""
        return self.match_psf_sigma is not None and (self.use_kernel or self.matched_pixel_cache)

    def _chunk_evicted(self, key, entry) -> None:
        """The residency manager's eviction seam: the current stream waits
        on an evicted chunk's upload, so the memory it frees is reused only
        after its copy, even where no scan of it waited."""
        if isinstance(entry.payload, _Chunk) and entry.payload.dev.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(entry.payload.dev.ready)

    def _wait(self, chunk: _Chunk) -> None:
        """The current stream waits on the chunk's upload (no host sync)."""
        if chunk.dev.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(chunk.dev.ready)

    def _resident_chunk(self, layout: str, exec_ds: PackedDataset, start: int,
                        stop: int) -> _Chunk:
        """The resident chunk of packs [start, stop), through the LRU.

        A miss uploads it (`PackedDataset.to_device_chunk`, copies on the
        engine's side stream) with its bank slice.  Under `_stream_matched`
        the chunk is the matched-pixel cache: its first scan matches it
        (`_chunk_operands`), and repeat queries hit the matched chunk.  The
        key carries the PSF state, so a retuned engine misses.  The entry is
        charged for the chunk and a bank slice that rides with it; a matched
        build's raw pixels and bank slice are its transient bytes.
        """
        matched = self._stream_matched()
        state = self._psf_state()
        key = (layout, start, stop, "matched", state) if matched else (layout, start, stop, state)
        bank = self.psf_kernel_bank(layout)
        bank_bytes = self._bank_pack_nbytes(layout) * (stop - start)

        def build():
            if self.device.type == "cuda" and self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            dev = exec_ds.to_device_chunk(start, stop, self.device, self._copy_stream)
            self.pack_upload_count += 1
            kern = None if bank is None else _upload(bank[start:stop], self.device)
            return _Chunk(dev, match=kern) if matched else _Chunk(dev, bank=kern)

        nbytes = exec_ds.chunk_nbytes(start, stop) + (0 if matched else bank_bytes)
        transient = exec_ds.pixels[0].nbytes * (stop - start) + bank_bytes if matched else 0
        return self.residency.acquire(key, nbytes, build, transient_bytes=transient,
                                      cost=COST_MATCHED_CHUNK if matched else COST_RAW_CHUNK)

    def _chunk_operands(self, chunk: _Chunk) -> Tuple[DevicePackedDataset, Optional[torch.Tensor]]:
        """A resident chunk's scan operands -> (dataset, bank for plain scans).

        A matched chunk is matched on its first scan: ONE ungated
        ``psf_match`` launch over every slot (the plain version on the plain
        path) and its flag (`ops.matched_finite`), counted in
        ``matched_builds``, not as a pass.  The gated pre-pass of the eager
        path is bitwise the ungated one on every slot a pass reads, so the
        matched bits are the same.
        """
        if chunk.match is not None:
            dev = chunk.dev
            every = torch.arange(dev.n_packs, dtype=torch.int32, device=self.device)
            if self.use_kernel:
                pixels = warp_ops.psf_match(dev.pixels, every, chunk.match,
                                            host_idx=np.arange(dev.n_packs, dtype=np.int32))
            else:
                pixels = warp_ref.psf_match_ref(dev.pixels, every, chunk.match)
            finite = warp_ops.matched_finite(dev.finite, every, chunk.match)
            chunk.dev = dataclasses.replace(dev, pixels=pixels, finite=finite)
            chunk.match = None
            self.matched_builds += 1
        return chunk.dev, chunk.bank

    def _stream_windows(self, exec_ds: PackedDataset, gate_any: np.ndarray) -> List[ScanWindow]:
        """The chunk-aligned window schedule of a (P,) any-gate (every pack
        when sparse execution is off: the dense scan streams everything)."""
        gated = np.nonzero(gate_any)[0] if self.sparse else np.arange(exec_ds.n_packs)
        return window_schedule(gated, exec_ds.n_packs, self._chunk_packs(exec_ds))

    def _run_stream_windows(self, layout: str, exec_ds: PackedDataset,
                            windows: List[ScanWindow], dispatch):
        """Walk a window schedule -> the window partials summed on the device.

        ``dispatch(chunk, window)`` scans one window and gives its partial
        tuple (fresh tensors: the first window's become the sums, added to
        in place).  The next chunk is acquired before this window's scan is
        enqueued, so its upload (on the side stream, after that chunk's
        allocation) overlaps this scan: the double buffer.  The current
        stream waits on each chunk's upload just before the scans that read
        it.  No host sync here.
        """
        cur = self._resident_chunk(layout, exec_ds, windows[0].start, windows[0].stop)
        self._wait(cur)
        acc = None
        for i, win in enumerate(windows):
            nxt = None
            if i + 1 < len(windows):
                nxt = self._resident_chunk(layout, exec_ds, windows[i + 1].start,
                                           windows[i + 1].stop)
            out = dispatch(cur, win)
            acc = out if acc is None else tuple(a.add_(b) for a, b in zip(acc, out))
            del out   # the next window's output is not allocated beside this one
            if nxt is not None:
                self._wait(nxt)
            cur = nxt
        return acc

    def _stream(self, layout: str, gate: np.ndarray, qvec: np.ndarray, grid_ra, grid_dec,
                reduce: str):
        """One query's (P, cap) gate, or a batch's (K, P, cap) gates, streamed
        -> (coadd, depth, contrib on the host, windows, passes, (uploads,
        hits, evictions), seconds).

        Each pass of the estimator (`_estimate`) walks the window schedule
        (`_run_stream_windows`): per window one launch of its kernel (its
        plain version off the kernel path) over the chunk, with chunk-local
        indices and the window's compacted gate.  The first pass also sums
        the accepted slots.  The between-pass operands stay on the device;
        the query's one host sync is `_sync` at the end.
        """
        exec_ds, _ = self.exec_dataset(layout)
        batch = gate.ndim == 3
        windows = self._stream_windows(exec_ds, gate.any(axis=(0, 2) if batch else 1))
        compact = compact_window_gates if batch else compact_window_gate
        slots = (1, 2) if batch else (0, 1)
        contrib: List[torch.Tensor] = []
        counters0 = (self.residency.uploads, self.residency.hits, self.residency.evictions)
        t1 = time.perf_counter()

        def run_pass(name, *fixed):
            first = not contrib

            def dispatch(chunk, win):
                dev, bank = self._chunk_operands(chunk)
                idx = _upload(win.pack_idx, self.device)
                accept = self._accept(dev, idx, compact(gate, win), qvec)
                fns = _pass_fns(batch, self.use_kernel, dev.finite, win.pack_idx, bank)
                self.dispatch_count += 1
                out = fns[name](dev.pixels, dev.wcs, idx, accept.to(torch.float32), grid_ra,
                                grid_dec, *fixed)
                out = out if isinstance(out, tuple) else (out,)
                return out + (accept.sum(slots),) if first else out

            acc = self._run_stream_windows(layout, exec_ds, windows, dispatch)
            if first:
                contrib.append(acc[-1])
                acc = acc[:-1]
            return acc if len(acc) > 1 else acc[0]

        passes, (coadd, depth) = _estimate(reduce, self.clip_k, self.median_bins, run_pass)
        coadd_h, depth_h, contrib_h = _sync([coadd, depth, contrib[0]])
        elapsed = time.perf_counter() - t1
        counters = (self.residency.uploads - counters0[0], self.residency.hits - counters0[1],
                    self.residency.evictions - counters0[2])
        return coadd_h, depth_h, contrib_h, windows, passes, counters, elapsed

    def _empty_streaming_result(self, plan: CoaddPlan) -> CoaddResult:
        """The empty selection under a budget: exact zeros, no window, no
        upload, no launch (and no window-stat reduction over no windows)."""
        npix = plan.query.npix
        stats = JobStats(method=plan.method, files_considered=0, files_contributing=0,
                         packs_touched=0, t_locate_s=plan.t_locate_s, t_map_reduce_s=0.0,
                         t_total_s=plan.t_locate_s, dispatches=0, reduce=plan.reduce,
                         peak_resident_bytes=self._peak_resident_bytes())
        return CoaddResult(np.zeros((npix, npix), np.float32), np.zeros((npix, npix), np.float32),
                           stats)

    def _execute_streaming(self, plan: CoaddPlan) -> CoaddResult:
        """One query under a device budget (any estimator): its gated packs
        streamed in residency-chunk windows (`_stream`)."""
        gate = self._exec_gate(plan)
        if not gate.any():
            return self._empty_streaming_result(plan)
        grid_ra, grid_dec = self._plan_grids(plan)
        m_builds0, d0 = self.matched_builds, self.dispatch_count
        coadd, depth, contrib, windows, passes, (up, hits, ev), elapsed = self._stream(
            plan.layout, gate, plan.qvec, grid_ra, grid_dec, plan.reduce)
        stats = JobStats(
            method=plan.method,
            files_considered=int(gate.sum()),
            files_contributing=int(contrib),
            packs_touched=plan.packs_touched,
            t_locate_s=plan.t_locate_s,
            t_map_reduce_s=elapsed,
            t_total_s=plan.t_locate_s + elapsed,
            dispatches=self.dispatch_count - d0,
            packs_gated=int(gate.any(axis=1).sum()),
            packs_scanned=passes * sum(w.budget for w in windows),
            scan_budget=max(w.budget for w in windows),
            reduce=plan.reduce,
            reduce_passes=passes,
            windows=passes * len(windows),
            chunk_uploads=up,
            residency_hits=hits,
            residency_evictions=ev,
            matched_cache_builds=self.matched_builds - m_builds0,
            matched_cache_hits=hits if self._stream_matched() else 0,
            peak_resident_bytes=self._peak_resident_bytes(),
        )
        return CoaddResult(coadd, depth, stats)

    def _execute_batch_streaming(self, plans: List[CoaddPlan], gates: np.ndarray,
                                 qvecs: np.ndarray) -> List[CoaddResult]:
        """K plans under a device budget (any estimator): the windows of the
        union of their gates, each window one batched launch a pass for all
        K queries, one host sync for the batch.  The interval, launches,
        scanned packs and residency counters go to the first result's
        stats.  ``batch_scan`` is a digest of the union's packs for a query
        whose own gated packs differ (its own streamed run sums other
        windows)."""
        layout = plans[0].layout
        if not gates.any():
            return [self._empty_streaming_result(p) for p in plans]
        grids = [self._plan_grids(p) for p in plans]
        grids_ra = torch.stack([g[0] for g in grids])
        grids_dec = torch.stack([g[1] for g in grids])
        m_builds0, d0 = self.matched_builds, self.dispatch_count
        coadds, depths, contribs, windows, passes, (up, hits, ev), elapsed = self._stream(
            layout, gates, qvecs, grids_ra, grids_dec, plans[0].reduce)
        union = np.concatenate([w.sel for w in windows]).astype(np.int64)
        digest = hashlib.sha256(union.tobytes()).hexdigest()[:16]
        results = []
        for i, p in enumerate(plans):
            first = i == 0
            own = np.nonzero(gates[i].any(axis=1))[0] if self.sparse else union
            t_mr = elapsed if first else 0.0
            results.append(CoaddResult(coadds[i], depths[i], JobStats(
                method=p.method,
                files_considered=int(gates[i].sum()),
                files_contributing=int(contribs[i]),
                packs_touched=p.packs_touched,
                t_locate_s=p.t_locate_s,
                t_map_reduce_s=t_mr,
                t_total_s=p.t_locate_s + t_mr,
                dispatches=(self.dispatch_count - d0) if first else 0,
                packs_gated=int(gates[i].any(axis=1).sum()),
                packs_scanned=passes * sum(w.budget for w in windows) if first else 0,
                scan_budget=max(w.budget for w in windows),
                reduce=p.reduce,
                reduce_passes=passes,
                windows=passes * len(windows),
                chunk_uploads=up if first else 0,
                residency_hits=hits if first else 0,
                residency_evictions=ev if first else 0,
                matched_cache_builds=(self.matched_builds - m_builds0) if first else 0,
                matched_cache_hits=hits if first and self._stream_matched() else 0,
                peak_resident_bytes=self._peak_resident_bytes(),
                batch_scan="" if np.array_equal(own, union) else digest,
            )))
        return results
