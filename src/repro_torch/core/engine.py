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

Later slices of the port (batched queries, PSF matching, streaming
residency) are not here; their arguments raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mapper, reducer
from repro_torch.core.plan import (
    CoaddPlan,
    SparseScanIndex,
    compact_gate,
    sparse_pack_index,
)
from repro_torch.core.prefilter import (
    SpatialIndex,
    camcol_dec_table,
    glob_file_mask,
    glob_pack_mask,
)
from repro_torch.core.query import CoaddQuery
from repro_torch.core.seqfile import (
    DevicePackedDataset,
    PackedDataset,
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
    dispatches: int = 1            # scan launches: 1 fused kernel launch, or
                                   #   one map+reduce step per scanned pack
                                   #   on the plain path
    packs_gated: int = 0           # execution-layout packs the gate opens
    packs_scanned: int = 0         # packs the pass actually visits
    scan_budget: int = 0           # bucket the pass covers (n_packs if dense)
    reduce: str = "mean"           # estimator: "mean" | "clipped" | "median"
    reduce_passes: int = 1         # passes over the gated packs: 1, 2 or 3


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


def _accept_from_meta(ints, floats, qvec):
    """Algorithm-2 acceptance on (..., cap) metadata: band, valid, box, time."""
    band_ok = ints["band_id"].to(torch.float32) == qvec[0]
    valid = ints["image_id"] >= 0
    ra_ok = (floats["ra_max"] >= qvec[1]) & (floats["ra_min"] <= qvec[2])
    dec_ok = (floats["dec_max"] >= qvec[3]) & (floats["dec_min"] <= qvec[4])
    t_ok = (floats["t_obs"] >= qvec[5]) & (floats["t_obs"] <= qvec[6])
    return band_ok & valid & ra_ok & dec_ok & t_ok


def _scan_coadd(dev: DevicePackedDataset, idx: torch.Tensor, accept: torch.Tensor,
                grid_ra, grid_dec, use_kernel: bool):
    """One pass over the packs ``idx`` of the resident layout -> (coadd, depth).

    ``use_kernel`` sends the whole pass through ONE ``coadd_fused`` launch;
    otherwise each pack goes through the plain map stage and local reduce
    (the kernel's plain version, the counterpart of the reference's XLA path).
    """
    if use_kernel:
        return warp_ops.coadd_fused(
            dev.pixels, dev.wcs, idx, accept.to(torch.float32), grid_ra, grid_dec
        )
    return warp_ref.coadd_scan_ref(dev.pixels, dev.wcs, idx, accept, grid_ra, grid_dec)


def _robust_passes(dev: DevicePackedDataset, idx: torch.Tensor, accept: torch.Tensor,
                   grid_ra, grid_dec, reduce: str, clip_k: float, median_bins: int,
                   use_kernel: bool):
    """A robust estimator's passes over the packs ``idx`` -> (coadd, depth).

    Moments; then, for the median, the histogram bounds, the histogram pass
    and its median; then the clip radius and the clip pass.  Centre, radius
    and bounds are fixed (Q, Q) operands computed between passes in plain
    torch on the device, as the reference computes them in XLA outside its
    Pallas kernels.  ``use_kernel`` makes each pass one launch of its CUDA
    kernel; otherwise each pass is the kernel's plain version, which maps
    and reduces pack by pack and never holds the query's warped stack.
    """
    if use_kernel:
        moments, hist, clip = warp_ops.coadd_moments, warp_ops.coadd_hist, warp_ops.coadd_clip
    else:
        moments, hist, clip = (warp_ref.moments_scan_ref, warp_ref.hist_scan_ref,
                               warp_ref.clip_scan_ref)
    scan = (dev.pixels, dev.wcs, idx, accept.to(torch.float32), grid_ra, grid_dec)
    s0, s1, s2 = moments(*scan)
    mu, sigma = reducer.clip_stats(s0, s1, s2)
    if reduce == "median":
        lo, w, inv_w = reducer.hist_bounds(s0, s1, s2, median_bins)
        center = reducer.hist_median(hist(*scan, lo, inv_w, median_bins), s0, lo, w)
    else:
        center = mu
    return clip(*scan, center, reducer.clip_threshold(center, sigma, clip_k))


class CoaddEngine:
    """Plans queries on the host, executes them against resident layouts.

    Pixels cross host->device once per layout (`device_dataset`); every
    query is one pass over the gated packs — one ``coadd_fused`` launch with
    ``use_kernel=True`` — or, for a robust estimator, two or three passes.
    ``clip_k`` is the sigma-clip radius and ``median_bins`` the binapprox
    histogram's resolution.  ``device`` defaults to ``"cuda"``; constructing
    an engine for a CUDA device on a machine without one raises.
    """

    def __init__(
        self,
        survey: Survey,
        pack_capacity: int = 64,
        use_kernel: bool = True,
        sparse: bool = True,
        device="cuda",
        match_psf_sigma: Optional[float] = None,
        device_budget_bytes: Optional[int] = None,
        clip_k: float = 3.0,
        median_bins: int = 16,
    ):
        if match_psf_sigma is not None:
            raise NotImplementedError("PSF matching is not ported yet")
        if device_budget_bytes is not None:
            raise NotImplementedError("streaming residency (a device budget) is not ported yet")
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
        self.camcol_dec = camcol_dec_table(survey)
        self.sql = SpatialIndex.build(survey)
        self._datasets: Dict[str, PackedDataset] = {}
        self._exec_cache: Dict[str, Tuple[PackedDataset, Optional[SlotRemap]]] = {}
        self._device_cache: Dict[str, DevicePackedDataset] = {}
        self._pack_capacity = pack_capacity
        self.pack_upload_count = 0   # host->device uploads of whole layouts
        self.dispatch_count = 0      # executed passes over the gated packs

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
        """Device bytes of every resident layout."""
        return sum(d.nbytes for d in self._device_cache.values())

    def _grids(self, query: CoaddQuery):
        gr, gd = mapper.query_grid_sky(query)
        return (torch.from_numpy(gr).to(self.device),
                torch.from_numpy(gd).to(self.device))

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
        return CoaddPlan("raw_fits", "per_file", gate, _query_vec(query), query, t_locate)

    def plan_raw_fits_prefiltered(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("per_file")
        t0 = time.perf_counter()
        mask = glob_file_mask(self.survey.meta_table(), query, self.camcol_dec)
        gate = ds.valid & mask[:, None]  # per-file layout: pack == file
        t_locate = time.perf_counter() - t0
        return CoaddPlan("raw_fits_prefiltered", "per_file", gate,
                         _query_vec(query), query, t_locate)

    def plan_unstructured_seq(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("unstructured")
        t0 = time.perf_counter()
        gate = ds.valid.copy()  # unprunable by construction: read every pack
        t_locate = time.perf_counter() - t0
        return CoaddPlan("unstructured_seq", "unstructured", gate,
                         _query_vec(query), query, t_locate)

    def plan_structured_seq_prefiltered(self, query: CoaddQuery) -> CoaddPlan:
        ds = self.dataset("structured")
        t0 = time.perf_counter()
        mask = glob_pack_mask(ds, query, self.camcol_dec)
        gate = ds.valid & mask[:, None]
        t_locate = time.perf_counter() - t0
        return CoaddPlan("structured_seq_prefiltered", "structured", gate,
                         _query_vec(query), query, t_locate)

    def _plan_sql(self, layout: str, query: CoaddQuery, method: str) -> CoaddPlan:
        ds = self.dataset(layout)
        t0 = time.perf_counter()
        ids = self.sql.select(query)
        # The index maps ids -> (pack, slot): exact selection is a
        # metadata-only slot gate over the resident containers.
        gate = ds.slot_mask(ids)
        t_locate = time.perf_counter() - t0
        return CoaddPlan(method, layout, gate, _query_vec(query), query, t_locate)

    def plan_sql_unstructured(self, query: CoaddQuery) -> CoaddPlan:
        return self._plan_sql("unstructured", query, "sql_unstructured")

    def plan_sql_structured(self, query: CoaddQuery) -> CoaddPlan:
        return self._plan_sql("structured", query, "sql_structured")

    def _exec_gate(self, plan: CoaddPlan) -> np.ndarray:
        """A plan's gate in execution-layout coordinates (remapped if reblocked)."""
        _, remap = self.exec_dataset(plan.layout)
        return remap.apply(plan.gate) if remap is not None else plan.gate

    def _sparse_index(self, gate: np.ndarray) -> Optional[SparseScanIndex]:
        """The gather plan for a gate, or None for the dense scan.

        Sparse execution pays only when the bucket is smaller than the
        layout; a full-archive gate scans densely.
        """
        if not self.sparse:
            return None
        sp = sparse_pack_index(gate)
        return sp if sp.worthwhile else None

    # ----- execution: one pass against resident data -----
    def _scan_operands(self, plan: CoaddPlan):
        """The pass's operands for a plan.

        Returns the resident layout, the (G,) int32 pack index on the device
        (``arange(P)`` when dense) and the (G, cap) bool slots the pass
        accumulates.  Acceptance runs as plain torch ops on the gathered
        metadata (in the reference it is XLA outside the Pallas kernel),
        ANDed with the gate.
        """
        exec_ds, _ = self.exec_dataset(plan.layout)
        dev = self.device_dataset(plan.layout)
        gate = self._exec_gate(plan)
        sp = self._sparse_index(gate)
        if sp is None:
            pack_idx = np.arange(exec_ds.n_packs, dtype=np.int32)
            scan_gate = gate
        else:
            pack_idx = sp.pack_idx
            scan_gate = compact_gate(gate, sp)
        idx = torch.from_numpy(pack_idx).to(self.device)
        rows = idx.to(torch.int64)
        accept = _accept_from_meta(
            {k: v[rows] for k, v in dev.ints.items()},
            {k: v[rows] for k, v in dev.floats.items()},
            torch.from_numpy(plan.qvec).to(self.device),
        ) & torch.from_numpy(scan_gate).to(self.device)
        return dev, idx, accept

    def execute(self, plan: CoaddPlan) -> CoaddResult:
        """Run a plan: device-resident packs + (P, cap) slot gate."""
        self.device_dataset(plan.layout)  # the one upload stays out of the timing
        grid_ra, grid_dec = self._grids(plan.query)
        t1 = time.perf_counter()
        dev, idx, accept = self._scan_operands(plan)
        if plan.reduce == "mean":
            passes = 1
            coadd, depth = _scan_coadd(dev, idx, accept, grid_ra, grid_dec, self.use_kernel)
        else:
            passes = 3 if plan.reduce == "median" else 2
            coadd, depth = _robust_passes(dev, idx, accept, grid_ra, grid_dec, plan.reduce,
                                          self.clip_k, self.median_bins, self.use_kernel)
        self.dispatch_count += passes
        contrib = int(accept.sum())
        coadd_h, depth_h = coadd.cpu().numpy(), depth.cpu().numpy()
        t2 = time.perf_counter()
        gate = self._exec_gate(plan)
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
                dispatches=passes * (1 if self.use_kernel else n_scanned),
                packs_gated=int(gate.any(axis=1).sum()),
                packs_scanned=n_scanned,
                scan_budget=n_scanned,
                reduce=plan.reduce,
                reduce_passes=passes,
            ),
        )

    def run(self, query: CoaddQuery, method: str, reduce: str = "mean") -> CoaddResult:
        """Plan + execute one query; ``reduce`` picks the estimator (DESIGN.md §11):
        "mean", "clipped" (k-sigma-clipped mean) or "median" (binapprox
        median, then a clip about it)."""
        return self.execute(self.plan(query, method, reduce))
