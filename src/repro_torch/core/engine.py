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
over the chunk right after its upload, reused by repeat queries.

The fault domain (DESIGN.md §8), under a budget: with ``on_fault="retry"``
(the default) or ``"quarantine"`` every window runs through a
`WindowTracker`: transient upload failures retry with capped backoff, a
chunk whose upload holds a NaN or inf (its flags come from the same device
reduction as the slot flag, read just before the chunk's first scan) is
dropped and uploaded again, persistent poison is gated out (``partial``,
``uncovered_packs``), stragglers get a digest-checked backup
(``straggler_factor``), and each window's partial is journaled as a copy in
pinned host memory, so a killed query resumes replaying only its missing
windows; with ``journal_dir`` the journals and the brick store's host tier
persist on disk (`durable`).  ``on_fault="raise"`` is the bare window loop.
The tracker changes scheduling, never arithmetic: a clean tracked query is
bitwise the bare loop's, with the same single host sync.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mapper, psf, reducer
from repro_torch.core.bricks import BrickCover, BrickGrid
from repro_torch.core.durable import BrickSpill, DiskJournal, JournalStore
from repro_torch.core.faults import ChaosInjector, PoisonedChunkError
from repro_torch.core.jobtracker import (
    BrickTask,
    FaultCounters,
    MaterializeReport,
    MaterializeTracker,
    WindowTracker,
)
from repro_torch.core.plan import (
    CoaddPlan,
    ScanWindow,
    SparseScanIndex,
    compact_gate,
    compact_gates,
    compact_window_gate,
    compact_window_gates,
    grid_digest,
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
    # Fault domain (DESIGN.md §8): what the `WindowTracker` did to finish
    # this streamed query.  Counters are additive (a batch puts them on its
    # first result); ``partial``/``uncovered_packs`` are descriptive, on
    # every result of a job, and carried through `BrickMeta`.  All zero on
    # the eager path and on clean tracked runs.
    retries: int = 0               # failed attempts that were re-executed
    speculative_windows: int = 0   # straggler backups launched (digest-checked)
    quarantined_packs: int = 0     # packs gated out after persistent poison
    resumed_windows: int = 0       # journal hits replayed instead of re-run
    partial: bool = False          # True when quarantine removed coverage
    uncovered_packs: Tuple[int, ...] = ()  # exec-layout packs quarantined out
    requarantine_released: int = 0 # packs restored by `reverify_quarantined`
                                   #   since the previous streamed result
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
    its first scan (a matched chunk); its `ResidencyManager` key and first
    pack (the poison check drops a poisoned chunk by its key)."""

    dev: DevicePackedDataset
    bank: Optional[torch.Tensor] = None
    match: Optional[torch.Tensor] = None
    key: Tuple = ()
    start: int = 0


@dataclasses.dataclass
class _Staged:
    """A window partial journaled in memory: its copy on the host (pinned on
    a CUDA device) and the event that copy ends at (None on the host)."""

    host: Tuple[torch.Tensor, ...]
    ready: Optional[torch.cuda.Event] = None


class _DiskWindows:
    """A `DiskJournal` as the tracker's journal: a commit waits on the
    staged partial's copy event (not the device) and writes its host
    arrays; reads give the replayed host arrays."""

    def __init__(self, disk: DiskJournal, host_arrays):
        self.disk = disk
        self._host_arrays = host_arrays

    def __contains__(self, key) -> bool:
        return key in self.disk

    def __getitem__(self, key):
        return self.disk[key]

    def __setitem__(self, key, staged: _Staged) -> None:
        self.disk[key] = self._host_arrays(staged)

    def __len__(self) -> int:
        return len(self.disk)

    def drain(self) -> None:
        self.disk.drain()

    def close(self) -> None:
        self.disk.close()


@dataclasses.dataclass
class _Streamed:
    """What `CoaddEngine._stream` gives back, on the host: the sums, the
    accepted slots, the files considered (quarantined packs' slots out), the
    schedule, the passes, the residency counters (uploads, hits,
    evictions), seconds, the fault counters and the packs quarantined."""

    coadd: np.ndarray
    depth: np.ndarray
    contrib: np.ndarray
    considered: np.ndarray
    windows: List[ScanWindow]
    passes: int
    counters: Tuple[int, int, int]
    elapsed: float
    faults: FaultCounters
    quarantined: Tuple[int, ...]


def _accumulate(acc, part):
    """Add a window's partial into the running sums, in place."""
    return tuple(a.add_(b) for a, b in zip(acc, part))


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
    budget.  The fault domain of a streamed query (DESIGN.md §8):
    ``on_fault`` ("retry", "quarantine" or "raise", the bare loop),
    ``fault_max_attempts`` and ``fault_backoff_s`` (capped exponential
    backoff), ``straggler_factor`` (speculate a window slower than that
    multiple of the median; off by default, it times every window),
    ``verify_digests`` (off by default: the host hashes every chunk it
    uploads, a sha256 of every streamed byte, against the layout's digests,
    made once; it catches finite corruption that the NaN/Inf flags cannot),
    ``fault_injector`` (a `ChaosInjector` drill), ``journal_dir``
    (window journals and the brick store's host tier on disk; orphan
    journals older than ``journal_max_age_s`` are swept here).  The fault
    knobs and the injector may be changed on a live engine.  ``device``
    defaults to ``"cuda"``; constructing an engine for a CUDA device on a
    machine without one raises.
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
        on_fault: str = "retry",
        fault_max_attempts: int = 3,
        fault_backoff_s: float = 0.05,
        straggler_factor: Optional[float] = None,
        verify_digests: bool = False,
        fault_injector: Optional[ChaosInjector] = None,
        journal_dir: Optional[str] = None,
        journal_max_age_s: float = 7 * 86400.0,
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
        # Fault policy (DESIGN.md §8) of the streamed executors: "retry"
        # re-executes transient failures under a WindowTracker, "quarantine"
        # also gates persistently poisoned packs out (a partial result),
        # "raise" runs the bare window loop (any fault aborts the query).
        if on_fault not in ("retry", "quarantine", "raise"):
            raise ValueError(f"on_fault must be 'retry', 'quarantine', or 'raise'; "
                             f"got {on_fault!r}")
        self.on_fault = on_fault
        self.fault_max_attempts = fault_max_attempts
        self.fault_backoff_s = fault_backoff_s
        self.straggler_factor = straggler_factor
        self.verify_digests = verify_digests
        self.fault_injector = fault_injector
        # Window journals of killed queries, by job key, capped: a re-issued
        # query replays only its missing windows.  With ``journal_dir`` they
        # are `DiskJournal`s and the brick store's host tier persists.
        self._journals: "OrderedDict[str, object]" = OrderedDict()
        self._journal_cap = 16
        self.journal_dir = journal_dir
        self.journal_store: Optional[JournalStore] = None
        brick_spill = None
        if journal_dir is not None:
            self.journal_store = JournalStore(os.path.join(journal_dir, "windows"),
                                              max_age_s=journal_max_age_s)
            brick_spill = BrickSpill(os.path.join(journal_dir, "bricks"))
        # Quarantine releases since the last streamed result, reported as
        # JobStats.requarantine_released by the next one.
        self._requarantine_pending = 0
        # A straggler's backup dispatches from a worker thread: the window
        # launches (engine and wrapper counters, the matched-chunk build)
        # run one at a time; the waits stay outside.
        self._dispatch_lock = threading.Lock()
        self.event_waits = 0         # host waits on a CUDA event (a chunk's
                                     #   poison flags, a disk journal commit)
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
        self.residency.fault_hook = self._upload_fault
        self.brick_store = BrickStore(self.residency, self.device, spill=brick_spill)

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
        otherwise), materializes the misses inline (each a normal `execute`
        under the fault domain, stored for the next query), and merges the
        tiles in one mosaic launch.  The stats sum the misses' scan work and
        fault counters; ``partial`` and ``uncovered_packs`` come from every
        tile's `BrickMeta`.
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
            residual.windows += s.windows
            residual.chunk_uploads += s.chunk_uploads
            residual.residency_hits += s.residency_hits
            residual.residency_evictions += s.residency_evictions
            residual.matched_cache_builds += s.matched_cache_builds
            residual.matched_cache_hits += s.matched_cache_hits
            residual.retries += s.retries
            residual.speculative_windows += s.speculative_windows
            residual.quarantined_packs += s.quarantined_packs
            residual.resumed_windows += s.resumed_windows
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
                windows=residual.windows,
                chunk_uploads=residual.chunk_uploads,
                residency_hits=residual.residency_hits,
                residency_evictions=residual.residency_evictions,
                matched_cache_builds=residual.matched_cache_builds,
                matched_cache_hits=residual.matched_cache_hits,
                retries=residual.retries,
                speculative_windows=residual.speculative_windows,
                quarantined_packs=residual.quarantined_packs,
                resumed_windows=residual.resumed_windows,
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

        Every cell is one normal planned and executed brick query (under a
        budget, streamed under the fault domain), journaled by its presence
        in the store: a killed job re-issued with the same arguments skips
        finished bricks and resumes the in-flight one from its window
        journal.  ``region=(ra_bounds, dec_bounds)`` restricts it to the
        cells whose nominal box intersects the region.
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
            task.retries = res.stats.retries
            task.resumed_windows = res.stats.resumed_windows

        tracker = MaterializeTracker(max_attempts=self.fault_max_attempts,
                                     backoff_s=self.fault_backoff_s)
        return MaterializeReport(tracker.run(tasks, is_done, run_one))

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

    def _upload_fault(self, key) -> None:
        """The residency manager's upload seam (every miss, right where the
        transfer is issued): a chaos drill's `ChaosInjector.on_upload`."""
        if self.fault_injector is not None:
            self.fault_injector.on_upload(key)

    def _wait(self, chunk: _Chunk) -> None:
        """The current stream waits on the chunk's upload (no host sync)."""
        if chunk.dev.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(chunk.dev.ready)

    def _wait_event(self, event) -> None:
        """The host waits on a CUDA event (counted in ``event_waits``)."""
        self.event_waits += 1
        event.synchronize()

    @property
    def _fault_tolerant(self) -> bool:
        """Whether streamed queries run through the `WindowTracker` (§8)."""
        return self.on_fault != "raise"

    @property
    def _verify_chunks(self) -> bool:
        """Whether chunk builds are verified: whenever faults are handled or
        injected (with ``on_fault="raise"`` and an injector, poison is still
        detected; it just aborts the query)."""
        return self._fault_tolerant or self.fault_injector is not None

    def _staged_chunk_pixels(self, exec_ds: PackedDataset, start: int, stop: int,
                             drop: FrozenSet[int]) -> Optional[np.ndarray]:
        """A chunk's host pixels to upload in place of the layout's slice,
        or None (DESIGN.md §8).

        A chaos drill corrupts a *copy* (`ChaosInjector.corrupt_chunk`): only
        a chunk the injector changes is staged; every other one uploads from
        the layout registered in place.  Under ``verify_digests`` every
        pack's host pixels (the copy or the layout's) are hashed against the
        layout's digests, and a mismatch raises `PoisonedChunkError` with
        the global packs; packs in ``drop`` (quarantined) are skipped: they
        go up as zeros.  The NaN/Inf check is not made here: the upload
        computes it on the device (`to_device_chunk(poison=True)`).
        """
        if not self._verify_chunks:
            return None
        src = exec_ds.pixels[start:stop]
        px = src
        if self.fault_injector is not None:
            px = self.fault_injector.corrupt_chunk(start, stop, src)
        if self.verify_digests:
            bad = exec_ds.verify_chunk(start, stop, px, skip=drop)
            if bad:
                raise PoisonedChunkError(bad, "host pixels differ from the layout's digest")
        return None if px is src else px

    def _resident_chunk(self, layout: str, exec_ds: PackedDataset, start: int,
                        stop: int, drop: FrozenSet[int] = frozenset()) -> _Chunk:
        """The resident chunk of packs [start, stop), through the LRU.

        A miss uploads it (`PackedDataset.to_device_chunk`, copies on the
        engine's side stream) with its bank slice.  Under `_stream_matched`
        the chunk is the matched-pixel cache: its first scan matches it
        (`_chunk_operands`), and repeat queries hit the matched chunk.  The
        key carries the PSF state, so a retuned engine misses.  The entry is
        charged for the chunk and a bank slice that rides with it; a matched
        build's raw pixels and bank slice are its transient bytes.

        ``drop`` lists quarantined global packs (§8): their rows go up as
        zeros and the key carries them, so a sanitized chunk never aliases
        the clean one.  A verified build (`_verify_chunks`) stages a chaos
        drill's corrupted copy, checks digests (`_staged_chunk_pixels`) and
        brings back the chunk's poison flags (`_check_poison`).
        """
        matched = self._stream_matched()
        state = self._psf_state()
        key = (layout, start, stop, "matched", state) if matched else (layout, start, stop, state)
        drop_here = tuple(sorted(p for p in drop if start <= p < stop))
        if drop_here:
            key = key + ("quarantine", drop_here)
        bank = self.psf_kernel_bank(layout)
        bank_bytes = self._bank_pack_nbytes(layout) * (stop - start)

        def build():
            if self.device.type == "cuda" and self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            staged = self._staged_chunk_pixels(exec_ds, start, stop, drop)
            dev = exec_ds.to_device_chunk(start, stop, self.device, self._copy_stream,
                                          pixels=staged, zero_packs=[p - start for p in drop_here],
                                          poison=self._verify_chunks)
            self.pack_upload_count += 1
            kern = None if bank is None else _upload(bank[start:stop], self.device)
            if matched:
                return _Chunk(dev, match=kern, key=key, start=start)
            return _Chunk(dev, bank=kern, key=key, start=start)

        nbytes = exec_ds.chunk_nbytes(start, stop) + (0 if matched else bank_bytes)
        transient = exec_ds.pixels[0].nbytes * (stop - start) + bank_bytes if matched else 0
        return self.residency.acquire(key, nbytes, build, transient_bytes=transient,
                                      cost=COST_MATCHED_CHUNK if matched else COST_RAW_CHUNK)

    def _check_poison(self, chunk: _Chunk) -> None:
        """Before a verified chunk's first scan: the host waits on its upload
        event and reads its poison flags (`to_device_chunk(poison=True)`).
        A pack holding a NaN or inf drops the chunk from the LRU (so the
        retry uploads it again instead of hitting it) and raises
        `PoisonedChunkError` with the global packs.  Read here, not when the
        chunk is acquired: the next chunk is acquired before this window is
        dispatched, and waiting there would serialize the double buffer.
        Quarantined packs went up as zeros, so they never trip it."""
        dev = chunk.dev
        if dev.poisoned is None:
            return
        if dev.ready is not None:
            self._wait_event(dev.ready)
        bad = [chunk.start + int(i) for i in np.nonzero(dev.poisoned.numpy())[0]]
        if bad:
            self.residency.drop_matching(lambda k: k == chunk.key)
            raise PoisonedChunkError(bad, "non-finite pixels in the uploaded chunk")
        dev.poisoned = None

    def _chunk_operands(self, chunk: _Chunk) -> Tuple[DevicePackedDataset, Optional[torch.Tensor]]:
        """A resident chunk's scan operands -> (dataset, bank for plain scans).

        A matched chunk is matched on its first scan: ONE ungated
        ``psf_match`` launch over every slot (the plain version on the plain
        path) and its flag (`ops.matched_finite`), counted in
        ``matched_builds``, not as a pass.  The gated pre-pass of the eager
        path is bitwise the ungated one on every slot a pass reads, so the
        matched bits are the same.  A verified chunk is checked for poison
        first (`_check_poison`), on its raw pixels.
        """
        self._check_poison(chunk)
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

    # ----- the fault domain's journals (DESIGN.md §8) -----
    def _job_key(self, tag: str, layout: str, gates: np.ndarray, qvecs: np.ndarray, npix: int,
                 windows: List[ScanWindow], grid_tag: str = "") -> str:
        """Cross-query identity of a streamed job's window journal.

        A digest over everything that determines a window partial's value:
        the job tag (method, estimator knobs, pass), layout, PSF state and
        program family (kernel or plain path), the gate and query-vector
        bytes, the output grid, the window partition itself, and the
        persistent quarantine set (a pack released between kill and resume
        changes the partials bitwise, so the resumed job must miss, not
        replay).  A resumed query replays journaled partials only when they
        are bitwise-valid for it.
        """
        quar = tuple(sorted(self.residency.quarantined_packs(layout)))
        h = hashlib.sha256()
        h.update(f"{tag}|{layout}|{npix}|{self._psf_state()}|k{int(self.use_kernel)}"
                 f"|{grid_tag}|q{quar}".encode())
        h.update(np.ascontiguousarray(gates).tobytes())
        h.update(np.ascontiguousarray(qvecs, np.float32).tobytes())
        for w in windows:
            h.update(np.array([w.start, w.stop, w.n_gated, w.budget], np.int64).tobytes())
        return h.hexdigest()

    def _reduce_tag(self, method: str, reduce: str, pass_tag: str) -> str:
        """Journal-identity tag of one robust pass: the method, every knob
        that changes the pass's partial bytes, and which pass it is (the
        moments and clip partials of one query never share a journal)."""
        return f"{method}|reduce={reduce}|k={self.clip_k}|b={self.median_bins}|pass={pass_tag}"

    def _journal_for(self, job_key: str):
        """The (possibly resumed) window journal of a job, LRU-capped.

        An in-memory dict of staged partials by default; with
        ``journal_dir`` a `DiskJournal` (behind `_DiskWindows`) that replays
        any valid on-disk prefix when opened: the resume path of a *fresh
        process* (the cap then only bounds open handles).
        """
        journal = self._journals.get(job_key)
        if journal is None:
            if self.journal_store is not None:
                journal = _DiskWindows(self.journal_store.open(job_key), self._host_partial)
            else:
                journal = {}
            self._journals[job_key] = journal
            while len(self._journals) > self._journal_cap:
                _, old = self._journals.popitem(last=False)
                if hasattr(old, "close"):
                    old.close()
        else:
            self._journals.move_to_end(job_key)
        return journal

    def _retire_journal(self, job_key: str) -> None:
        """Drop a completed job's window journal (memory and disk)."""
        old = self._journals.pop(job_key, None)
        if hasattr(old, "close"):
            old.close()
        if self.journal_store is not None:
            self.journal_store.remove(job_key)

    def reverify_quarantined(self, layout: Optional[str] = None) -> List[int]:
        """Re-verify quarantined packs against the host layout (§8).

        For every registered layout (or just ``layout``), re-hash the
        quarantined packs' *current* host pixels; packs that verify
        (repaired in place, or never corrupt on the host at all) leave the
        registry and regain coverage on the next query.  Returns the
        released global packs; their count also surfaces as
        ``JobStats.requarantine_released`` on the next streamed result.
        """
        layouts = [layout] if layout is not None else list(self.residency.quarantined)
        released: List[int] = []
        for lay in layouts:
            exec_ds, _ = self.exec_dataset(lay)
            released.extend(self.residency.reverify_quarantined(lay, exec_ds))
        self._requarantine_pending += len(released)
        return released

    def _take_requarantine_released(self) -> int:
        n, self._requarantine_pending = self._requarantine_pending, 0
        return n

    def _stage_partial(self, part) -> _Staged:
        """A finished window's partial journaled in memory: on a CUDA device
        a copy into pinned host memory enqueued on the compute stream (before
        the in-place sums can change the partial) and its event; on the host
        a copy."""
        if self.device.type != "cuda":
            return _Staged(tuple(t.clone() for t in part))
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in part)
        for h, t in zip(host, part):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return _Staged(host, ready)

    def _host_partial(self, staged: _Staged) -> Tuple[np.ndarray, ...]:
        """A staged partial's host arrays, once its copy has landed."""
        if staged.ready is not None:
            self._wait_event(staged.ready)
            staged.ready = None
        return tuple(t.numpy() for t in staged.host)

    def _load_partial(self, value) -> Tuple[torch.Tensor, ...]:
        """A journal hit as a partial on the device: a staged partial's
        pinned copy (its copy back was enqueued on the compute stream, so
        the upload after it needs no host wait), or the host arrays a
        `DiskJournal` replayed.  Fresh tensors: the sums are made in place."""
        if isinstance(value, _Staged):
            host = value.host
        else:
            host = tuple(torch.from_numpy(np.asarray(a)) for a in value)
        if self.device.type != "cuda":
            return tuple(t.clone() for t in host)
        return tuple((t if t.is_pinned() else t.pin_memory()).to(self.device, non_blocking=True)
                     for t in host)

    def _run_stream_windows(self, layout: str, exec_ds: PackedDataset,
                            windows: List[ScanWindow], dispatch, job_key: str,
                            keep_journal: bool = False):
        """Walk a window schedule -> (the window partials summed on the
        device, `FaultCounters`, packs quarantined).

        ``dispatch(chunk, window, dropped)`` scans one window and gives its
        partial tuple (fresh tensors: the first window's become the sums,
        added to in place); ``dropped`` are the quarantined packs it gates
        out.  No host sync here.

        With ``on_fault="raise"`` this is the bare loop: the next chunk is
        acquired before this window's scan is enqueued, so its upload (on
        the side stream, after that chunk's allocation) overlaps this scan,
        the double buffer; the current stream waits on each chunk's upload
        just before the scans that read it.  Otherwise a `WindowTracker`
        runs the same schedule in the same order: journaled under
        ``job_key`` (a killed query resumes replaying only missing windows),
        retried on transient faults and poison, optionally speculated, and
        quarantine-completed on persistent poison.  A robust pass keeps its
        journal (``keep_journal``) until the query's last pass completes.
        """
        if not self._fault_tolerant:
            cur = self._resident_chunk(layout, exec_ds, windows[0].start, windows[0].stop)
            self._wait(cur)
            acc = None
            for i, win in enumerate(windows):
                nxt = None
                if i + 1 < len(windows):
                    nxt = self._resident_chunk(layout, exec_ds, windows[i + 1].start,
                                               windows[i + 1].stop)
                out = dispatch(cur, win, frozenset())
                acc = out if acc is None else tuple(a.add_(b) for a, b in zip(acc, out))
                del out   # the next window's output is not allocated beside this one
                if nxt is not None:
                    self._wait(nxt)
                cur = nxt
            return acc, FaultCounters(), ()
        pre_quar = self.residency.quarantined_packs(layout)
        tracker = WindowTracker(policy=self.on_fault, max_attempts=self.fault_max_attempts,
                                backoff_s=self.fault_backoff_s,
                                straggler_factor=self.straggler_factor,
                                injector=self.fault_injector, quarantined=pre_quar)

        def acquire(win, drop):
            return self._resident_chunk(layout, exec_ds, win.start, win.stop, drop)

        def scan(chunk, win, drop):
            self._wait(chunk)
            return dispatch(chunk, win, drop)

        journal = self._journal_for(job_key)
        try:
            acc, quarantined = tracker.run(windows, acquire, scan, journal,
                                           stage=self._stage_partial, load=self._load_partial,
                                           accumulate=_accumulate)
        except BaseException:
            # Durability point: fsync a disk journal so a fatal error (an
            # injected kill, an OOM about to follow) leaves every finished
            # window committed for the resume.  A clean run skips it: its
            # journal is removed below.
            if hasattr(journal, "drain"):
                journal.drain()
            raise
        finally:
            # Fresh quarantines persist even when the query dies: later
            # queries skip the poison without paying the retry storm again
            # (released only by `reverify_quarantined`).
            fresh = tracker.quarantined - set(pre_quar)
            if fresh:
                self.residency.quarantine_packs(layout, fresh,
                                                getattr(exec_ds, "_pack_digest_cache", None))
        # Completed: the journal has served its purpose (a kill raises above
        # and keeps it: the resume contract).
        if not keep_journal:
            self._retire_journal(job_key)
        return acc, tracker.counters, tuple(quarantined)

    def _stream(self, layout: str, gate: np.ndarray, qvec: np.ndarray, grid_ra, grid_dec,
                reduce: str, tag: str, npix: int, grid_tag: str) -> _Streamed:
        """One query's (P, cap) gate, or a batch's (K, P, cap) gates, streamed.

        Each pass of the estimator (`_estimate`) walks the window schedule
        (`_run_stream_windows`): per window one launch of its kernel (its
        plain version off the kernel path) over the chunk, with chunk-local
        indices and the window's compacted gate, quarantined packs gated
        out.  The first pass also sums the accepted slots.  The between-pass
        operands stay on the device; the query's one host sync is `_sync` at
        the end.  Each pass journals under its own key (``tag``, and for a
        robust estimator the pass, `_reduce_tag`); a robust query retires
        its pass journals together once the last pass completes.
        """
        exec_ds, _ = self.exec_dataset(layout)
        batch = gate.ndim == 3
        windows = self._stream_windows(exec_ds, gate.any(axis=(0, 2) if batch else 1))
        compact = compact_window_gates if batch else compact_window_gate
        slots = (1, 2) if batch else (0, 1)
        contrib: List[torch.Tensor] = []
        first_quar: List[int] = []
        faults = FaultCounters()
        quarantined: set = set()
        pass_keys: List[str] = []
        counters0 = (self.residency.uploads, self.residency.hits, self.residency.evictions)
        t1 = time.perf_counter()

        def run_pass(name, *fixed):
            first = not contrib

            def dispatch(chunk, win, dropped):
                with self._dispatch_lock:
                    g = gate
                    if dropped:
                        # Quarantined packs (§8) go up as zeros and gate out,
                        # so depth and files exclude them: the partial=True
                        # report is the honest answer.
                        g = gate.copy()
                        g[(slice(None),) * batch + (sorted(dropped),)] = False
                    dev, bank = self._chunk_operands(chunk)
                    idx = _upload(win.pack_idx, self.device)
                    accept = self._accept(dev, idx, compact(g, win), qvec)
                    fns = _pass_fns(batch, self.use_kernel, dev.finite, win.pack_idx, bank)
                    self.dispatch_count += 1
                    out = fns[name](dev.pixels, dev.wcs, idx, accept.to(torch.float32), grid_ra,
                                    grid_dec, *fixed)
                    out = out if isinstance(out, tuple) else (out,)
                    return out + (accept.sum(slots),) if first else out

            pass_tag = tag if reduce == "mean" else self._reduce_tag(tag, reduce, name)
            job_key = self._job_key(pass_tag, layout, gate, qvec, npix, windows, grid_tag)
            pass_keys.append(job_key)
            acc, pfc, pquar = self._run_stream_windows(layout, exec_ds, windows, dispatch,
                                                       job_key, keep_journal=reduce != "mean")
            for f in dataclasses.fields(FaultCounters):
                setattr(faults, f.name, getattr(faults, f.name) + getattr(pfc, f.name))
            quarantined.update(pquar)
            if first:
                contrib.append(acc[-1])
                first_quar.extend(pquar)
                acc = acc[:-1]
            return acc if len(acc) > 1 else acc[0]

        passes, (coadd, depth) = _estimate(reduce, self.clip_k, self.median_bins, run_pass)
        if reduce != "mean":
            # The whole job completed: every pass journal is garbage now.
            for key in pass_keys:
                self._retire_journal(key)
        coadd_h, depth_h, contrib_h = _sync([coadd, depth, contrib[0]])
        elapsed = time.perf_counter() - t1
        counters = (self.residency.uploads - counters0[0], self.residency.hits - counters0[1],
                    self.residency.evictions - counters0[2])
        # Files considered: the gate's slots, without the packs the first
        # pass gated out (each pack lies in one window).
        considered = gate.sum(axis=slots) - gate[..., sorted(first_quar), :].sum(axis=slots)
        # Coverage honesty: only quarantined packs a gate opens are uncovered.
        opened = gate.any(axis=(0, 2) if batch else 1)
        quar = tuple(p for p in sorted(quarantined) if opened[p])
        return _Streamed(coadd_h, depth_h, contrib_h, considered, windows, passes, counters,
                         elapsed, faults, quar)

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
        r = self._stream(plan.layout, gate, plan.qvec, grid_ra, grid_dec, plan.reduce,
                         plan.method, plan.query.npix, grid_digest(plan.grid_sky))
        up, hits, ev = r.counters
        stats = JobStats(
            method=plan.method,
            files_considered=int(r.considered),
            files_contributing=int(r.contrib),
            packs_touched=plan.packs_touched,
            t_locate_s=plan.t_locate_s,
            t_map_reduce_s=r.elapsed,
            t_total_s=plan.t_locate_s + r.elapsed,
            dispatches=self.dispatch_count - d0,
            packs_gated=int(gate.any(axis=1).sum()),
            packs_scanned=r.passes * sum(w.budget for w in r.windows),
            scan_budget=max(w.budget for w in r.windows),
            reduce=plan.reduce,
            reduce_passes=r.passes,
            windows=r.passes * len(r.windows),
            chunk_uploads=up,
            residency_hits=hits,
            residency_evictions=ev,
            matched_cache_builds=self.matched_builds - m_builds0,
            matched_cache_hits=hits if self._stream_matched() else 0,
            peak_resident_bytes=self._peak_resident_bytes(),
            retries=r.faults.retries,
            speculative_windows=r.faults.speculative_windows,
            quarantined_packs=r.faults.quarantined_packs,
            resumed_windows=r.faults.resumed_windows,
            partial=bool(r.quarantined),
            uncovered_packs=r.quarantined,
            requarantine_released=self._take_requarantine_released(),
        )
        return CoaddResult(r.coadd, r.depth, stats)

    def _execute_batch_streaming(self, plans: List[CoaddPlan], gates: np.ndarray,
                                 qvecs: np.ndarray) -> List[CoaddResult]:
        """K plans under a device budget (any estimator): the windows of the
        union of their gates, each window one batched launch a pass for all
        K queries, one host sync for the batch.  The interval, launches,
        scanned packs, residency and fault counters go to the first result's
        stats; a quarantine's lost coverage to every result.  ``batch_scan``
        is a digest of the union's packs for a query whose own gated packs
        differ (its own streamed run sums other windows)."""
        layout = plans[0].layout
        if not gates.any():
            return [self._empty_streaming_result(p) for p in plans]
        grids = [self._plan_grids(p) for p in plans]
        grids_ra = torch.stack([g[0] for g in grids])
        grids_dec = torch.stack([g[1] for g in grids])
        m_builds0, d0 = self.matched_builds, self.dispatch_count
        r = self._stream(layout, gates, qvecs, grids_ra, grids_dec, plans[0].reduce,
                         "batch:" + plans[0].method, plans[0].npix,
                         "|".join(grid_digest(p.grid_sky) for p in plans))
        up, hits, ev = r.counters
        windows = r.windows
        released = self._take_requarantine_released()
        union = np.concatenate([w.sel for w in windows]).astype(np.int64)
        digest = hashlib.sha256(union.tobytes()).hexdigest()[:16]
        results = []
        for i, p in enumerate(plans):
            first = i == 0
            own = np.nonzero(gates[i].any(axis=1))[0] if self.sparse else union
            t_mr = r.elapsed if first else 0.0
            results.append(CoaddResult(r.coadd[i], r.depth[i], JobStats(
                method=p.method,
                files_considered=int(r.considered[i]),
                files_contributing=int(r.contrib[i]),
                packs_touched=p.packs_touched,
                t_locate_s=p.t_locate_s,
                t_map_reduce_s=t_mr,
                t_total_s=p.t_locate_s + t_mr,
                dispatches=(self.dispatch_count - d0) if first else 0,
                packs_gated=int(gates[i].any(axis=1).sum()),
                packs_scanned=r.passes * sum(w.budget for w in windows) if first else 0,
                scan_budget=max(w.budget for w in windows),
                reduce=p.reduce,
                reduce_passes=r.passes,
                windows=r.passes * len(windows),
                chunk_uploads=up if first else 0,
                residency_hits=hits if first else 0,
                residency_evictions=ev if first else 0,
                matched_cache_builds=(self.matched_builds - m_builds0) if first else 0,
                matched_cache_hits=hits if first and self._stream_matched() else 0,
                peak_resident_bytes=self._peak_resident_bytes(),
                retries=r.faults.retries if first else 0,
                speculative_windows=r.faults.speculative_windows if first else 0,
                quarantined_packs=r.faults.quarantined_packs if first else 0,
                resumed_windows=r.faults.resumed_windows if first else 0,
                partial=bool(r.quarantined),
                uncovered_packs=r.quarantined,
                requarantine_released=released if first else 0,
                batch_scan="" if np.array_equal(own, union) else digest,
            )))
        return results
