"""Query planning: the host-side half of the plan/execute engine split.

Counterpart of ``repro.core.plan`` (the single-query part).  The paper's
six methods differ only in how the set of candidate images is located.  A
`CoaddPlan` captures that job-init product — which layout to scan, the
static-shape (P, cap) slot gate selecting its candidate slots, and the query
vector the device-side acceptance test needs — plus the host time spent
locating (the paper's "construct file splits" phase, Fig. 8).

Sparse execution: a gate also *plans the scan extent*.  `sparse_pack_index`
derives from a gate the list of pack indices it actually opens, padded up to
a power-of-two *budget bucket* (capped at P), and the executor scans just
those packs of the resident layout — map work scales with the packs the
gate opens instead of P.

Batches (paper Fig. 5): `stack_plans` stacks same-layout plans into (K, P,
cap) gates and (K, 7) query vectors, and a sparse batch scans the union of
their packs (`union_sparse_index`), each query's gate re-selecting its own
slots within it (`compact_gates`).  `CoaddPlan.coalesce_key` is the
precondition of one batch as a hashable key, `cost_budget` the scan bucket
a service classes a plan by, and `fingerprint` the value identity of its
pixels.

Streaming residency: under a device budget a gate's packs are partitioned
by residency chunk into `ScanWindow`s (`window_schedule`), each scanned
with chunk-local indices over its own compacted gate
(`compact_window_gate`, `compact_window_gates` for a batch).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.query import CoaddQuery


@dataclasses.dataclass
class CoaddPlan:
    """One planned query: layout + slot gate + query vector + locate stats."""

    method: str
    layout: str            # "per_file" | "unstructured" | "structured"
    gate: np.ndarray       # (P, cap) bool — static shape, dynamic values
    qvec: np.ndarray       # (7,) float32 device-side acceptance vector
    query: CoaddQuery
    t_locate_s: float      # host job-init cost (prefilter/index, Fig. 8)
    # PSF target the plan was built under (None = matching off).  The
    # engine refuses to execute a plan under another target: its banks and
    # matched pixels are keyed per target.
    psf_target: Optional[float] = None
    reduce: str = "mean"   # estimator: "mean" | "clipped" | "median"
    # Output-grid override (DESIGN.md §9): precomputed (ra, dec) float32
    # sky coords, each (npix, npix), replacing the query's own TAN grid.
    # Brick plans put every brick (and brick window) on the one global
    # lattice, which is what makes mosaicked and fresh scans agree bitwise;
    # None keeps the per-query grid.
    grid_sky: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def npix(self) -> int:
        return self.query.npix

    @property
    def packs_touched(self) -> int:
        """Distinct containers the gate opens (§4.1.4 locality statistic)."""
        return int(self.gate.any(axis=1).sum())

    @property
    def cost_budget(self) -> int:
        """The budget bucket this plan scans at: the service's admission cost
        signal (DESIGN.md §10), which splits cheap plans from expensive."""
        return scan_budget(self.packs_touched, self.gate.shape[0])

    @property
    def coalesce_key(self) -> Tuple[str, int, str, Optional[float], str]:
        """Compatibility class for batching (DESIGN.md §10): plans stack into
        one `execute_batch` iff they share a resident layout, an output grid
        size, a grid override, a PSF target and an estimator."""
        return (self.layout, self.npix, grid_digest(self.grid_sky),
                self.psf_target, self.reduce)

    @property
    def fingerprint(self) -> str:
        """Value identity of this plan's pixels, independent of the method:
        a digest of layout, grid size and override, PSF target, estimator,
        gate bytes and query vector."""
        h = hashlib.sha256()
        h.update(
            f"{self.layout}|{self.npix}|{self.psf_target}"
            f"|{grid_digest(self.grid_sky)}|{self.reduce}".encode()
        )
        h.update(np.ascontiguousarray(self.gate).tobytes())
        h.update(np.ascontiguousarray(self.qvec, np.float32).tobytes())
        return h.hexdigest()


def grid_digest(grid_sky: Optional[Tuple[np.ndarray, np.ndarray]]) -> str:
    """Digest of an output-grid override ("" for the query's own grid)."""
    if grid_sky is None:
        return ""
    h = hashlib.sha256()
    for g in grid_sky:
        h.update(np.ascontiguousarray(g, np.float32).tobytes())
    return h.hexdigest()[:16]


def scan_budget(n_gated: int, n_packs: int) -> int:
    """Scan extent for a gate opening ``n_gated`` of ``n_packs`` packs.

    Buckets to the next power of two (minimum 1, capped at ``n_packs``), as
    the reference does.  An empty gate still budgets one pack: the executor
    scans a single all-False slot row, which yields an exact-zero coadd.
    """
    if n_packs <= 0:
        raise ValueError(f"n_packs must be positive, got {n_packs}")
    n = max(int(n_gated), 1)
    bucket = 1
    while bucket < n:
        bucket <<= 1
    return min(bucket, n_packs)


@dataclasses.dataclass
class SparseScanIndex:
    """A gate's padded pack-index vector: which packs to scan, and how many.

    ``pack_idx`` has length ``budget`` (= `scan_budget` bucket); entries past
    ``n_gated`` are padding (index 0) that the compacted gate masks to
    all-False, so duplicates contribute exact zeros.
    """

    pack_idx: np.ndarray   # (budget,) int32 indices into the pack axis
    n_gated: int           # packs the gate actually opens
    budget: int            # bucket == len(pack_idx)
    n_packs: int           # pack count of the layout the gate addresses

    @property
    def worthwhile(self) -> bool:
        """Gathering pays only when the bucket is smaller than the layout."""
        return self.budget < self.n_packs


def sparse_pack_index(gate: np.ndarray) -> SparseScanIndex:
    """Derive the padded pack-index vector a (P, cap) gate opens."""
    packs = np.nonzero(gate.any(axis=1))[0]
    n_packs = gate.shape[0]
    budget = scan_budget(len(packs), n_packs)
    idx = np.zeros((budget,), np.int32)
    idx[: len(packs)] = packs[:budget]
    return SparseScanIndex(idx, len(packs), budget, n_packs)


def compact_gate(gate: np.ndarray, sp: SparseScanIndex) -> np.ndarray:
    """(P, cap) gate -> (budget, cap) gate over the gathered packs.

    Padding rows are forced False so the duplicate pack-0 entries are
    rejected by the acceptance test.
    """
    g = gate[sp.pack_idx].copy()
    g[sp.n_gated :] = False
    return g


def union_sparse_index(gates: np.ndarray) -> SparseScanIndex:
    """Sparse index for a (K, P, cap) stack of gates: the union of their packs.

    A batch scans one pack index for all its queries; each query's
    compacted gate (`compact_gates`) then re-selects its own slots.
    """
    return sparse_pack_index(gates.any(axis=0))


def compact_gates(gates: np.ndarray, sp: SparseScanIndex) -> np.ndarray:
    """(K, P, cap) gates -> (K, budget, cap) over the union-gathered packs."""
    g = gates[:, sp.pack_idx].copy()
    g[:, sp.n_gated :] = False
    return g


@dataclasses.dataclass
class ScanWindow:
    """One streaming-residency window: a chunk of packs plus the scan over it.

    The streaming executor cannot assume the whole layout is
    device-resident, so a query's gated pack set is partitioned by *chunk*,
    the contiguous pack range the `ResidencyManager` uploads and evicts.
    Each window scans one chunk with the same budget-bucketed sparse program
    as the eager path, with chunk-local indices; window results are
    additive, so the executor uploads chunk N+1 behind chunk N's scan and
    syncs with the host once at the end.
    """

    start: int             # chunk pack range [start, stop) in layout coords
    stop: int
    sel: np.ndarray        # (n_gated,) *global* pack indices inside the chunk
    pack_idx: np.ndarray   # (budget,) chunk-local indices, 0-padded
    n_gated: int
    budget: int            # static bucket == len(pack_idx)

    @property
    def key(self) -> Tuple[int, int, int, int]:
        """Identity of this window within one query's schedule (windows
        partition the pack range, so it is unique there)."""
        return (self.start, self.stop, self.n_gated, self.budget)


def window_schedule(gated: np.ndarray, n_packs: int, chunk_packs: int) -> List[ScanWindow]:
    """Partition a sorted gated-pack vector into chunk-aligned scan windows.

    Chunks with no gated pack produce no window (their bytes never upload);
    an empty gate still yields one single-pack window, so an executor that
    scans it keeps the empty-gate contract: an all-False row, exact zeros.
    """
    if chunk_packs <= 0:
        raise ValueError(f"chunk_packs must be positive, got {chunk_packs}")
    if len(gated) == 0:
        return [ScanWindow(0, min(chunk_packs, n_packs), np.empty((0,), np.int64),
                           np.zeros((1,), np.int32), 0, 1)]
    windows: List[ScanWindow] = []
    for c in range(0, n_packs, chunk_packs):
        stop = min(c + chunk_packs, n_packs)
        sel = gated[(gated >= c) & (gated < stop)]
        if len(sel) == 0:
            continue
        budget = scan_budget(len(sel), stop - c)
        idx = np.zeros((budget,), np.int32)
        idx[: len(sel)] = sel - c
        windows.append(ScanWindow(c, stop, sel, idx, len(sel), budget))
    return windows


def compact_window_gate(gate: np.ndarray, win: ScanWindow) -> np.ndarray:
    """(P, cap) gate -> (budget, cap) gate over one window's gathered packs."""
    out = np.zeros((win.budget, gate.shape[-1]), bool)
    out[: win.n_gated] = gate[win.sel]
    return out


def compact_window_gates(gates: np.ndarray, win: ScanWindow) -> np.ndarray:
    """(K, P, cap) gates -> (K, budget, cap) over one window's packs."""
    out = np.zeros((gates.shape[0], win.budget, gates.shape[-1]), bool)
    out[:, : win.n_gated] = gates[:, win.sel]
    return out


def stack_plans(plans: Sequence[CoaddPlan]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack same-layout plans into (K, P, cap) gates + (K, 7) query vectors.

    One batch must share a layout (one resident dataset to scan), an output
    grid size and an estimator; all three are checked here.
    """
    if not plans:
        raise ValueError("cannot stack zero plans")
    layouts = {p.layout for p in plans}
    if len(layouts) != 1:
        raise ValueError(f"batched plans must share a layout, got {layouts}")
    npixes = {p.npix for p in plans}
    if len(npixes) != 1:
        raise ValueError(f"batched plans must share npix, got {npixes}")
    reduces = {p.reduce for p in plans}
    if len(reduces) != 1:
        raise ValueError(f"batched plans must share a reduce, got {reduces}")
    gates = np.stack([p.gate for p in plans])
    qvecs = np.stack([p.qvec for p in plans])
    return gates, qvecs


__all__: List[str] = [
    "CoaddPlan",
    "ScanWindow",
    "SparseScanIndex",
    "compact_gate",
    "compact_gates",
    "compact_window_gate",
    "compact_window_gates",
    "grid_digest",
    "scan_budget",
    "sparse_pack_index",
    "stack_plans",
    "union_sparse_index",
    "window_schedule",
]
