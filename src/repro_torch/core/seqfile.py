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
`DevicePackedDataset`, and `PackedDataset.to_device_chunk` one pack range of
it (streaming residency, DESIGN.md §6: page-locked host memory, copies on a
side CUDA stream).  `ResidencyManager` (an LRU under a byte budget, with the
persistent quarantine registry of DESIGN.md §8) and `BrickStore`
(materialized brick coadds, host and device tiers, optionally a persistent
`durable.BrickSpill`) are the residency hierarchy of DESIGN.md §9.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

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
    """Device-resident form of a `PackedDataset`, or of one pack range of it.

    A whole layout lives on the device, uploaded **once** and cached by the
    engine, so repeated queries never re-transfer pixels; under a device
    budget the engine holds chunks of it instead (`to_device_chunk`).
    Shapes mirror `PackedDataset`; arrays are torch tensors on one device.
    """

    pixels: torch.Tensor            # (P, cap, H, W) float32
    wcs: torch.Tensor               # (P, cap, 8) float32
    ints: Dict[str, torch.Tensor]   # (P, cap) int32 each; empty slots have
                                    #   image_id -1 (rejected by acceptance)
    floats: Dict[str, torch.Tensor] # (P, cap) float32 each
    finite: Optional[torch.Tensor] = None   # (P, cap) uint8, `finite_slots`
    # A chunk's upload event (`to_device_chunk` on a CUDA device): a reader's
    # stream waits on it before its first use.  None for a whole layout and
    # on the CPU.
    ready: Optional[Any] = None
    # A chunk's (P,) uint8 poison flags on the host (`to_device_chunk(...,
    # poison=True)`): 1 where a slot of the pack holds a NaN or an inf.  On
    # a CUDA device a pinned tensor that a copy fills before ``ready``: read
    # it only after ``ready`` has completed.
    poisoned: Optional[torch.Tensor] = None

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
        if self.finite is not None:
            tensors.append(self.finite)
        return sum(t.numel() * t.element_size() for t in tensors)


#: Largest |pixel| of a slot the pack scans may skip when it is rejected:
#: a rejected sample adds vm * 0 (and vm*vm/m * 0), exactly +-0 only while
#: vm and vm*vm are finite (csrc/warp.cu).  The bilinear vm is at most
#: 2**62 * (1 + 2**-21), so vm*vm < 2**125.
FINITE_LIMIT = 2.0 ** 62


def finite_slots(pixels: torch.Tensor, out: Optional[torch.Tensor] = None,
                 poisoned: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, cap, H, W) pixels -> (P, cap) uint8: 1 where every pixel of the
    slot is finite with |p| <= `FINITE_LIMIT`.  One reduction pass, each
    slot's min and max (a NaN propagates through both and compares false),
    written into ``out`` when given.  From the same pass, ``poisoned`` (a
    (P,) uint8 tensor, when given) gets 1 where a slot of the pack holds a
    NaN or an inf: the reference's chunk verification (`verify_chunk`)."""
    p, cap = pixels.shape[:2]
    if out is None:
        out = torch.empty((p, cap), dtype=torch.uint8, device=pixels.device)
    if out.numel():
        lo, hi = torch.aminmax(pixels.flatten(2), dim=-1)
        out.copy_((lo >= -FINITE_LIMIT) & (hi <= FINITE_LIMIT))
        if poisoned is not None:
            poisoned.copy_(~(torch.isfinite(lo) & torch.isfinite(hi)).all(dim=1))
    elif poisoned is not None:
        poisoned.zero_()
    return out


# Rebuild-cost classes for cost-aware eviction (DESIGN.md §9).  The number
# is a *class rank*, not a byte or second estimate: raw pixel chunks rebuild
# with one H2D copy, matched-pixel chunks additionally re-run the PSF
# convolution, and brick coadds rebuild only via a full streaming scan.
COST_RAW_CHUNK = 1.0
COST_MATCHED_CHUNK = 4.0
COST_BRICK = 16.0


@dataclasses.dataclass
class ResidentEntry:
    """One LRU-tracked resident payload (a pack chunk or a mesh window)."""

    key: Tuple
    payload: Any
    nbytes: int
    cost: float = COST_RAW_CHUNK  # rebuild-cost class (eviction priority)


class ResidencyManager:
    """Holds device-resident chunks under a byte budget with LRU eviction.

    The residency contract of DESIGN.md §6 and §9: the engine asks this
    manager for keyed device payloads.  A hit refreshes recency and costs
    nothing; a miss evicts least-recently-used entries until the new one
    fits, then calls the supplied build function.  The engine's streaming
    executors hold pack chunks here (`CoaddEngine(device_budget_bytes=...)`)
    beside the brick tier (`BrickStore`); with no budget nothing is evicted.

    Eviction drops the LRU reference and lets the runtime free the buffers
    once in-flight consumers finish — never an explicit ``delete()``, so a
    chunk evicted while its scan is still enqueued stays valid for exactly
    as long as that scan needs it.  ``budget_bytes=None`` disables eviction
    (everything stays resident, the eager contract).

    Two classes of entry share the budget:

    * **uploaded** chunks (``h2d=True``, the default) — pixels crossing
      host->device; counted in ``uploads``/``bytes_uploaded``.
    * **derived** entries (``h2d=False``) — arrays *computed on device*
      from already-resident operands, e.g. the PSF matched-pixel cache.
      They occupy budget bytes like anything else but add zero H2D
      traffic, so they get their own ``derived_builds``/``derived_bytes``
      counters and never inflate the upload accounting tests pin.

    Eviction is **cost-aware** (DESIGN.md §9): every entry carries a
    rebuild-cost class (``cost``), and pressure evicts the least-recently-
    used entry of the *cheapest class present* — raw chunks (one H2D copy
    to rebuild) go before matched-pixel chunks (H2D + convolution), which
    go before bricks (a full streaming scan).  With uniform costs this
    degrades exactly to plain LRU.

    ``peak_bytes`` reports *true* peak residency, not the advisory budget:
    eviction is drop-the-reference, so a chunk evicted while the most
    recently served entry's scan is still in flight stays alive device-side
    until that scan retires — the honest high-water mark is the resident
    bytes after an insert **plus** the in-flight entry the insert displaced
    (budget + one window's operands, matched-pixel cache included).
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._lru: "OrderedDict[Tuple, ResidentEntry]" = OrderedDict()
        self.uploads = 0        # builder invocations (chunk misses, H2D)
        self.hits = 0           # entries served without a build
        self.evictions = 0      # entries dropped to make room
        self.bytes_uploaded = 0 # cumulative H2D bytes across all misses
        self.derived_builds = 0 # device-computed entries built (no H2D)
        self.derived_bytes = 0  # cumulative bytes of derived builds
        self.peak_bytes = 0     # true peak residency (see class docstring)
        self.failed_builds = 0  # builds that raised (no entry inserted)
        # Upload failure seam (DESIGN.md §8): called with the entry key on
        # every miss, right where a real transfer would be issued — chaos
        # drills hook `ChaosInjector.on_upload` here.  May raise.
        self.fault_hook: Optional[Callable[[Tuple], None]] = None
        # Eviction seam (DESIGN.md §9): called with (key, entry) after an
        # entry is dropped under pressure — the `BrickStore` counts its
        # device replicas spilling back to the host tier here.  Must not
        # raise; exceptions are deliberately not swallowed (a broken hook
        # is a bug, not weather).
        self.on_evict: Optional[Callable[[Tuple, ResidentEntry], None]] = None
        self._last_key: Optional[Tuple] = None  # most recently served entry
        # Persistent quarantine registry (DESIGN.md §8): packs whose host
        # data failed verification persistently, per execution layout, each
        # with the *reference* content digest recorded at detection time
        # (None when no pre-corruption digest existed).  Queries gate these
        # out until `reverify_quarantined` proves the host data repaired.
        self.quarantined: Dict[str, Dict[int, Optional[bytes]]] = {}
        self.quarantine_released = 0  # packs restored by re-verification

    # ----- persistent quarantine (DESIGN.md §8) -----
    def quarantine_packs(
        self,
        layout: str,
        packs: Iterable[int],
        digests: Optional[Sequence[Optional[bytes]]] = None,
    ) -> None:
        """Register persistently poisoned packs for ``layout``.

        ``digests`` is the per-pack reference digest list (the host
        seqfile's `pack_digests` cache) when one predates the corruption;
        packs without a reference re-verify on the NaN/Inf scan alone.
        """
        reg = self.quarantined.setdefault(layout, {})
        for p in packs:
            p = int(p)
            ref = None
            if digests is not None and p < len(digests):
                ref = digests[p]
            reg.setdefault(p, ref)

    def quarantined_packs(self, layout: str) -> FrozenSet[int]:
        return frozenset(self.quarantined.get(layout, ()))

    def reverify_quarantined(self, layout: str, exec_ds) -> List[int]:
        """Re-hash quarantined packs against the host seqfile; release matches.

        A pack is released when its *current* host pixels are finite and,
        when a reference digest was recorded at quarantine time, hash back
        to that reference: the host data was repaired (or was never bad,
        only its transfers were).  Released packs leave the registry, their
        sanitized chunk-cache entries drop (so the next query rebuilds full
        coverage), and ``quarantine_released`` counts them.
        """
        reg = self.quarantined.get(layout)
        if not reg:
            return []
        released: List[int] = []
        for p, ref in sorted(reg.items()):
            row = np.ascontiguousarray(exec_ds.pixels[p])
            if not np.isfinite(row).all():
                continue  # still poisoned
            if ref is not None and hashlib.sha256(row.tobytes()).digest() != ref:
                continue  # finite but still not the ingested bytes
            released.append(p)
        for p in released:
            del reg[p]
        if not reg:
            del self.quarantined[layout]
        if released:
            # Sanitized chunks (key carries the "quarantine" drop tuple)
            # are stale now; drop them so coverage rebuilds immediately.
            self.drop_matching(
                lambda k: isinstance(k, tuple) and "quarantine" in k
                and k and k[0] == layout
            )
            self.quarantine_released += len(released)
        return released

    @property
    def bytes_resident(self) -> int:
        return sum(e.nbytes for e in self._lru.values())

    @property
    def n_resident(self) -> int:
        return len(self._lru)

    def acquire(
        self,
        key: Tuple,
        nbytes: int,
        build: Callable[[], Any],
        h2d: bool = True,
        transient_bytes: int = 0,
        cost: float = COST_RAW_CHUNK,
    ) -> Any:
        """Return the resident payload for ``key``, building on miss.

        ``h2d=False`` marks a *derived* entry (computed on device from
        resident operands): budget-counted, but not upload-counted.
        ``transient_bytes`` declares device bytes the *build itself* holds
        alive beyond the entry (e.g. the raw pixel chunk a matched-pixel
        build convolves from, dropped once the convolution retires) — they
        join the peak candidate so the high-water mark stays honest.
        ``cost`` is the entry's rebuild-cost class (see class docstring):
        eviction pressure takes the LRU entry of the cheapest class first.
        """
        entry = self._lru.get(key)
        if entry is not None:
            self._lru.move_to_end(key)
            self.hits += 1
            self._last_key = key
            return entry.payload
        in_flight = 0
        if self.budget_bytes is not None:
            # Evict until the newcomer fits: cheapest rebuild-cost class
            # first, LRU within the class (OrderedDict iteration order IS
            # recency, oldest first, so the first minimum wins ties).  A
            # chunk larger than the whole budget still loads (the scan
            # needs it); the budget is then transiently exceeded by that
            # one chunk, never by two.
            while self._lru and self.bytes_resident + nbytes > self.budget_bytes:
                victim = min(
                    self._lru, key=lambda k: self._lru[k].cost
                )
                evicted = self._lru.pop(victim)
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(victim, evicted)
                if victim == self._last_key:
                    # The entry a consumer may still be scanning: its
                    # buffers outlive the eviction until that scan retires.
                    in_flight = evicted.nbytes
        try:
            if self.fault_hook is not None:
                self.fault_hook(key)
            payload = build()
        except BaseException:
            # Failed-build contract: no entry is inserted and no upload is
            # counted, so a retry re-acquires cleanly.  Evictions already
            # performed stand — the newcomer's room was made, the newcomer
            # never arrived — which keeps the LRU consistent (budget is an
            # upper bound, never violated by a failure).
            self.failed_builds += 1
            raise
        self._lru[key] = ResidentEntry(key, payload, nbytes, cost)
        if h2d:
            self.uploads += 1
            self.bytes_uploaded += nbytes
        else:
            self.derived_builds += 1
            self.derived_bytes += nbytes
        self.peak_bytes = max(
            self.peak_bytes,
            self.bytes_resident + in_flight + max(transient_bytes, 0),
        )
        self._last_key = key
        return payload

    def resident(self, key: Tuple) -> bool:
        """Whether ``key`` is device-resident right now (no recency touch)."""
        return key in self._lru

    def drop_matching(self, pred: Callable[[Tuple], bool]) -> int:
        """Drop entries whose key satisfies ``pred`` (a deliberate release
        — e.g. a retuned engine shedding the old PSF target's matched
        pixels — not budget pressure, so ``evictions`` is untouched;
        reference-drop semantics as ever)."""
        stale = [k for k in self._lru if pred(k)]
        for k in stale:
            del self._lru[k]
            if k == self._last_key:
                self._last_key = None
        return len(stale)

    def clear(self) -> None:
        """Drop every resident entry (a reset, not budget pressure — the
        ``evictions`` counter tracks only LRU evictions forced by misses)."""
        self._lru.clear()
        self._last_key = None


@dataclasses.dataclass
class BrickMeta:
    """Provenance a materialized brick carries into mosaicked results."""

    partial: bool = False                    # quarantine removed coverage
    uncovered_packs: Tuple[int, ...] = ()    # exec-layout packs missing
    files_considered: int = 0
    files_contributing: int = 0


class BrickStore:
    """The materialized-coadd tier of the residency hierarchy (DESIGN.md §9).

    Two tiers per (brick, band, psf_state[, estimator]) key:

    * a **host tier**, always written at `put` (the brick's result is on the
      host already), holding the coadd and weight (depth) maps and
      `BrickMeta`.  It is also the materialization journal:
      `CoaddEngine.materialize_bricks` skips any brick already present.
    * a **device tier**: entries of the shared `ResidencyManager` at
      `COST_BRICK`, the most expensive rebuild class, uploaded with
      ``torch.from_numpy(...).to(device)``.  Eviction drops only the device
      replica; the host copy stands, so a later query re-uploads (one H2D
      copy) instead of re-scanning the archive.  ``spilled`` counts those
      pressure drops through the manager's eviction seam; ``spill_loads``
      counts serves that had to re-upload.

    Staleness is carried by the key, never checked here: the engine keys
    bricks on its PSF state, so a retuned engine misses and re-materializes.

    With a ``spill`` backend (`durable.BrickSpill`, wired by
    ``CoaddEngine(journal_dir=...)``) the host tier is *persistent*: every
    `put` writes an atomically renamed, self-checksummed file, and lookups
    that miss the in-memory host dict reload (and digest-verify) from disk,
    so materialized bricks survive process death and `materialize_bricks`
    in a fresh process skips them.  A reload that fails verification counts
    a plain miss (the file is dropped) and the brick rematerializes.
    """

    def __init__(self, residency: ResidencyManager, device="cpu", spill=None):
        self.residency = residency
        self.device = torch.device(device)
        self.spill = spill
        self._host: Dict[Tuple, Tuple[np.ndarray, np.ndarray, BrickMeta]] = {}
        self.hits = 0         # serves straight from the device tier
        self.spill_loads = 0  # serves that re-uploaded the host copy
        self.misses = 0       # lookups with no materialized brick at all
        self.spilled = 0      # device replicas dropped under LRU pressure
        self.disk_loads = 0   # host-tier reloads from the persistent spill
        prev = residency.on_evict

        def _count_spill(key: Tuple, entry: ResidentEntry) -> None:
            if isinstance(key, tuple) and key and key[0] == "brick":
                self.spilled += 1
            if prev is not None:
                prev(key, entry)

        residency.on_evict = _count_spill

    def __len__(self) -> int:
        return len(self._host)

    def contains(self, key: Tuple) -> bool:
        """Whether a verified brick exists (in memory or reloadable).

        The materialization journal check: a disk candidate is loaded and
        digest-verified *here*, so a corrupted spill file never reports a
        brick as done; it rematerializes instead.
        """
        return key in self._host or self._load_spill(key)

    def _load_spill(self, key: Tuple) -> bool:
        """Reload ``key`` from the persistent spill into the host tier."""
        if self.spill is None or key in self._host:
            return key in self._host
        got = self.spill.load(key)  # digest-verified; corrupt -> None
        if got is None:
            return False
        coadd, depth, meta = got
        self._host[key] = (
            coadd,
            depth,
            BrickMeta(
                partial=bool(meta.get("partial", False)),
                uncovered_packs=tuple(meta.get("uncovered_packs", ())),
                files_considered=int(meta.get("files_considered", 0)),
                files_contributing=int(meta.get("files_contributing", 0)),
            ),
        )
        self.disk_loads += 1
        return True

    def keys(self):
        return self._host.keys()

    def meta(self, key: Tuple) -> BrickMeta:
        self._load_spill(key)
        return self._host[key][2]

    def host_arrays(self, key: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        """The host-tier (coadd, depth) copies — test/debug access."""
        self._load_spill(key)
        coadd, depth, _ = self._host[key]
        return coadd, depth

    def _nbytes(self, key: Tuple) -> int:
        coadd, depth, _ = self._host[key]
        return int(coadd.nbytes) + int(depth.nbytes)

    def _acquire(self, key: Tuple):
        coadd, depth, _ = self._host[key]
        return self.residency.acquire(
            key,
            self._nbytes(key),
            lambda: (torch.from_numpy(coadd).to(self.device),
                     torch.from_numpy(depth).to(self.device)),
            h2d=True,
            cost=COST_BRICK,
        )

    def put(self, key: Tuple, coadd: np.ndarray, depth: np.ndarray,
            meta: Optional[BrickMeta] = None):
        """Store a finished brick (host write-through + device insert).

        Returns the device-tier (coadd, depth) payload so the caller can
        mosaic immediately without a store lookup (which would miscount a
        fresh insert as a cache hit).
        """
        m = meta or BrickMeta()
        self._host[key] = (
            np.ascontiguousarray(coadd, np.float32),
            np.ascontiguousarray(depth, np.float32),
            m,
        )
        if self.spill is not None:
            # Durable write-through (DESIGN.md §8): the brick survives
            # process death; a crashed materialization resumes past it.
            self.spill.save(
                key,
                self._host[key][0],
                self._host[key][1],
                {
                    "partial": bool(m.partial),
                    "uncovered_packs": [int(p) for p in m.uncovered_packs],
                    "files_considered": int(m.files_considered),
                    "files_contributing": int(m.files_contributing),
                },
            )
        return self._acquire(key)

    def fetch(self, key: Tuple):
        """``(coadd_dev, depth_dev, meta, tier)`` or None when absent.

        ``tier`` is ``"device"`` (already resident) or ``"host"`` (the
        spill path: the device replica was evicted; serving re-uploads)."""
        if key not in self._host and not self._load_spill(key):
            self.misses += 1
            return None
        was_resident = self.residency.resident(key)
        coadd, depth = self._acquire(key)
        if was_resident:
            self.hits += 1
        else:
            self.spill_loads += 1
        return coadd, depth, self._host[key][2], ("device" if was_resident else "host")

    def drop_device(self) -> int:
        """Drop every device replica (host tier stands) — the deliberate
        spill used by tests/drills; LRU pressure does this organically."""
        return self.residency.drop_matching(
            lambda k: isinstance(k, tuple) and bool(k) and k[0] == "brick"
        )

    def clear(self) -> None:
        """Forget every materialized brick, every tier, disk included."""
        self._host.clear()
        self.drop_device()
        if self.spill is not None:
            self.spill.clear()


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
    # Whether ``pixels`` is page-locked in place (`pin`, streaming residency).
    _pinned: bool = dataclasses.field(default=False, init=False, repr=False)

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

        The eager residency contract: with no device budget this is the only
        place pack pixels cross host->device; everything downstream indexes
        and masks the resident tensors on the device.  Under a budget the
        engine uploads `to_device_chunk` windows instead.
        """
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        pixels = put(self.pixels)
        return DevicePackedDataset(
            pixels=pixels,
            wcs=put(self.wcs),
            ints={k: put(v) for k, v in self.ints.items()},
            floats={k: put(v) for k, v in self.floats.items()},
            finite=finite_slots(pixels),
        )

    def pin(self) -> float:
        """Page-lock ``pixels`` in place (``cudaHostRegister``), once, so
        `to_device_chunk` copies them asynchronously -> the seconds it took
        (0.0 when already pinned).

        Raises if the registration fails: a copy from pageable memory would
        block the host, so there is no fallback to one.  The registration
        ends when the array is freed.
        """
        if self._pinned or self.pixels.nbytes == 0:
            return 0.0
        if not self.pixels.flags.c_contiguous:
            raise ValueError("pixels must be C-contiguous to pin in place")
        owner = self.pixels
        while isinstance(owner.base, np.ndarray):
            owner = owner.base
        cudart = torch.cuda.cudart()
        ptr, nbytes = self.pixels.ctypes.data, self.pixels.nbytes
        t0 = time.perf_counter()
        err = int(cudart.cudaHostRegister(ptr, nbytes, 0))
        if err != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: CUDA error {err}")
        seconds = time.perf_counter() - t0
        weakref.finalize(owner, cudart.cudaHostUnregister, ptr).atexit = False
        if not torch.from_numpy(self.pixels[:1]).is_pinned():
            raise RuntimeError("registered pixels do not read as page-locked")
        self._pinned = True
        return seconds

    def to_device_chunk(self, start: int, stop: int, device, stream=None,
                        pixels: Optional[np.ndarray] = None, zero_packs: Sequence[int] = (),
                        poison: bool = False) -> DevicePackedDataset:
        """Upload the pack range [start, stop) as its own resident chunk,
        with its per-slot `finite` flag (`finite_slots` of the uploaded
        pixels, computed on the device).

        The fault-tolerant build path (DESIGN.md §8): ``pixels`` replaces
        the layout's slice by a host copy (a chaos drill's corrupted copy,
        staged through pinned memory); ``zero_packs`` (chunk-local indices
        of quarantined packs) go up as zero rows, zeroed on the device after
        the copy; ``poison`` also fills the chunk's ``poisoned`` flags from
        the same reduction as the slot flag.

        On a CUDA device the tensors are allocated on the current stream and
        filled by copies issued on ``stream`` (a side stream; the current
        one when None) after an event recorded right after the allocation,
        so the copies never overwrite memory a scan enqueued before still
        reads.  The pixels copy straight from the layout's page-locked array
        (`pin`), the small columns through pinned staging copies, and the
        flag follows the pixels on the same stream; the host returns with
        the work enqueued, and the chunk's ``ready`` event is what a
        reader's stream waits on before its first use (the double buffer:
        this upload overlaps the scans already enqueued).  A reader must
        wait on ``ready`` before the chunk is dropped.  On the CPU the
        chunk's tensors view the host arrays.
        """
        sl = slice(start, stop)
        arrays = [self.pixels[sl] if pixels is None else pixels, self.wcs[sl],
                  *(v[sl] for v in self.ints.values()), *(v[sl] for v in self.floats.values())]
        device = torch.device(device)
        ready = poisoned = None
        if device.type != "cuda":
            tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
            if len(zero_packs):
                tensors[0] = tensors[0].clone()   # the CPU tensor views the host array
                for i in zero_packs:
                    tensors[0][i].zero_()
            poisoned = torch.empty(stop - start, dtype=torch.uint8) if poison else None
            finite = finite_slots(tensors[0], poisoned=poisoned)
        else:
            self.pin()
            compute = torch.cuda.current_stream(device)
            side = compute if stream is None else stream
            srcs = [torch.from_numpy(arrays[0]) if pixels is None
                    else torch.from_numpy(np.ascontiguousarray(pixels)).pin_memory()]
            srcs += [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrays[1:]]
            tensors = [torch.empty_like(s, device=device) for s in srcs]
            finite = torch.empty((stop - start, self.capacity), dtype=torch.uint8, device=device)
            if poison:
                poisoned = torch.empty(stop - start, dtype=torch.uint8, pin_memory=True)
            allocated = torch.cuda.Event()
            allocated.record(compute)
            side.wait_event(allocated)
            with torch.cuda.stream(side):
                for t, src in zip(tensors, srcs):
                    t.copy_(src, non_blocking=True)
                for i in zero_packs:
                    tensors[0][i].zero_()
                # A temporary of the side stream, as the reduction's are: its
                # memory returns to the side stream's pool, so no later
                # allocation on the compute stream can take it while the
                # copy below still reads it.
                bad = torch.empty(stop - start, dtype=torch.uint8, device=device) if poison else None
                finite_slots(tensors[0], out=finite, poisoned=bad)
                if poison:
                    poisoned.copy_(bad, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
        n_int = len(self.ints)
        return DevicePackedDataset(
            pixels=tensors[0],
            wcs=tensors[1],
            ints=dict(zip(self.ints, tensors[2:2 + n_int])),
            floats=dict(zip(self.floats, tensors[2 + n_int:])),
            finite=finite,
            ready=ready,
            poisoned=poisoned,
        )

    # ----- chunk verification (DESIGN.md §8) -----
    def pack_digests(self) -> List[bytes]:
        """Per-pack content digests of the *host* pixels (the ground truth).

        Built lazily on first use and cached: the host seqfile is immutable
        once packed, so these digests are what a staged chunk must reproduce
        for `verify_chunk`'s corruption check.
        """
        cache = getattr(self, "_pack_digest_cache", None)
        if cache is None:
            cache = [
                hashlib.sha256(
                    np.ascontiguousarray(self.pixels[p]).tobytes()
                ).digest()
                for p in range(self.n_packs)
            ]
            self._pack_digest_cache = cache
        return cache

    def verify_chunk(
        self,
        start: int,
        stop: int,
        pixels: np.ndarray,
        skip: FrozenSet[int] = frozenset(),
    ) -> List[int]:
        """Global pack indices in [start, stop) whose host pixels differ from
        the layout's digests (`pack_digests`): the finite corruption that
        only a digest catches, at sha256 cost a build.  ``skip`` holds
        already-quarantined packs, about to go up as zeros.  Non-finite
        pixels are found on the device instead, from the upload itself
        (`to_device_chunk(poison=True)`), without reading the host bytes
        again.
        """
        digests = self.pack_digests()
        return [start + local for local in range(stop - start)
                if start + local not in skip
                and hashlib.sha256(np.ascontiguousarray(pixels[local]).tobytes()).digest()
                != digests[start + local]]

    def pack_nbytes(self) -> int:
        """Device bytes of ONE resident pack: pixels, WCS, the metadata
        columns and its slots' finite flag."""
        per_pack = (
            self.pixels[0].nbytes
            + self.wcs[0].nbytes
            + sum(v[0].nbytes for v in self.ints.values())
            + sum(v[0].nbytes for v in self.floats.values())
            + self.capacity
        )
        return int(per_pack)

    def chunk_nbytes(self, start: int, stop: int) -> int:
        """Device bytes a resident [start, stop) chunk will occupy."""
        return self.pack_nbytes() * max(stop - start, 0)

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
