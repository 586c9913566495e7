"""Fault taxonomy and deterministic chaos injection (DESIGN.md §8).

Counterpart of ``repro.core.faults``; host-only, so a copy.  At cluster
scale failures are the norm (paper §3): the framework hides transient
faults by re-executing, routes around stragglers by speculating, and
contains bad inputs by quarantine, without changing the answer.  This
module holds the two host halves of that contract:

* the **fault taxonomy** (`classify`) that the trackers share: transient
  errors are retried with capped exponential backoff, fatal errors escape
  at once.  The split is deliberate policy, not exception pedigree: device
  and transfer failures surface as bare ``RuntimeError``, so that type is
  transient by default, while `DeterminismError` (two executions of one
  task disagreeing) must never be retried;
* the **chaos harness** (`FaultSchedule`, `ChaosInjector`, `PoisonSpec`)
  that injects failures at the engine's real seams (chunk uploads through
  the `ResidencyManager`, a chunk's host pixels before upload, window
  dispatch, mid-query kills) by deterministic ordinal, so every drill is
  reproducible and the healed result can be held bitwise against the
  fault-free run.  `FaultSchedule.seeded` draws from
  ``np.random.default_rng`` exactly as the reference does: one seed gives
  one schedule in both packages.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


# ----- fault taxonomy -----
class FaultError(Exception):
    """Base of the engine's own fault types (injected or detected)."""


class TransientFault(FaultError):
    """A retryable failure: lost upload RPC, flaky transfer, worker loss."""


class FatalFault(FaultError):
    """A failure retrying cannot fix; escapes every retry net."""


class DeterminismError(FatalFault):
    """Two executions of one idempotent task produced different digests."""


class QueryKilled(FatalFault):
    """Injected mid-query kill: the query dies, its journal survives."""


class PoisonedChunkError(FaultError):
    """Staged chunk pixels failed verification (NaN/Inf or digest mismatch).

    Carries the *global* (execution-layout) pack indices that failed, so the
    quarantine policy can gate exactly those packs out and report them as
    ``uncovered_packs``.
    """

    def __init__(self, packs: Iterable[int], reason: str = "verification failed"):
        self.packs = tuple(sorted(int(p) for p in packs))
        super().__init__(f"poisoned packs {self.packs}: {reason}")


# RuntimeError is transient by policy: the device runtimes report device and
# transfer errors as RuntimeError.  FatalFault subclasses
# (DeterminismError, QueryKilled) are checked first and always escape.
_TRANSIENT_TYPES = (
    TransientFault,
    ConnectionError,
    TimeoutError,
    InterruptedError,
    OSError,
    RuntimeError,
)


def classify(exc: BaseException) -> str:
    """``"transient"`` (retry) or ``"fatal"`` (escape) for an exception.

    `PoisonedChunkError` classifies transient — a corrupted transfer heals on
    re-upload — but the `WindowTracker` intercepts it *before* classification
    so persistent poison can escalate to quarantine instead of exhausting
    retries.
    """
    if isinstance(exc, FatalFault):
        return "fatal"
    if isinstance(exc, (PoisonedChunkError,) + _TRANSIENT_TYPES):
        return "transient"
    return "fatal"


# ----- deterministic chaos schedule -----
@dataclasses.dataclass
class PoisonSpec:
    """Corrupt one pack's staged pixels for ``count`` chunk builds.

    ``count=None`` poisons every build (persistent bad input — the quarantine
    case); a finite count models transfer corruption that heals on retry.
    ``mode="flip"`` corrupts with *finite* values, which only the digest
    check catches (``CoaddEngine(verify_digests=True)``) — the NaN/Inf scan
    is blind to it by design.
    """

    pack: int
    mode: str = "nan"            # "nan" | "inf" | "flip"
    count: Optional[int] = 1


@dataclasses.dataclass
class FaultSchedule:
    """A reproducible failure plan, addressed by deterministic ordinals.

    * ``upload_fail_ordinals`` — fail the k-th chunk-build attempt (counted
      across the whole engine lifetime) with a `TransientFault`: the upload
      RPC that never arrived.
    * ``poison`` — corrupt staged pixels of specific packs (`PoisonSpec`).
    * ``slow_windows`` — sleep inside the k-th window execution: a straggler.
    * ``kill_after_windows`` — raise `QueryKilled` once N windows have
      completed (after journaling, so resume has something to replay).
    """

    upload_fail_ordinals: Tuple[int, ...] = ()
    poison: Tuple[PoisonSpec, ...] = ()
    slow_windows: Dict[int, float] = dataclasses.field(default_factory=dict)
    kill_after_windows: Optional[int] = None

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_uploads: int,
        n_windows: int,
        gated_packs: np.ndarray,
        upload_fails: int = 1,
        poisons: int = 1,
        stragglers: int = 1,
        slow_s: float = 0.05,
    ) -> "FaultSchedule":
        """Draw a schedule from a seed (the CI chaos-smoke drill generator).

        The caller supplies the query's shape — how many chunk builds and
        windows a clean run performs, and which packs its gate opens — so
        every drawn fault lands on a seam the query actually crosses.
        """
        rng = np.random.default_rng(seed)
        pool = np.asarray(gated_packs, np.int64)
        ordinals = tuple(
            sorted(
                int(o)
                for o in rng.choice(
                    max(n_uploads, 1),
                    size=min(upload_fails, max(n_uploads, 1)),
                    replace=False,
                )
            )
        )
        specs = tuple(
            PoisonSpec(pack=int(p), mode="nan", count=1)
            for p in rng.choice(pool, size=min(poisons, len(pool)), replace=False)
        )
        # Stragglers only speculate once a duration median exists, so draw
        # slow ordinals past the first window.
        lo = min(1, max(n_windows - 1, 0))
        slow = {
            int(o): slow_s
            for o in rng.choice(
                np.arange(lo, max(n_windows, lo + 1)),
                size=min(stragglers, max(n_windows - lo, 1)),
                replace=False,
            )
        }
        return cls(ordinals, specs, slow, None)


class ChaosInjector:
    """Replays a `FaultSchedule` against the engine's real seams.

    One injector = one deterministic drill: it keeps its own ordinal
    counters (upload attempts seen, windows executed, windows completed) and
    an ``injected`` Counter the tests assert against, so a drill proves its
    faults actually fired rather than silently missing every seam.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.upload_attempts = 0
        self.window_execs = 0
        self.windows_completed = 0
        self.injected: "collections.Counter[str]" = collections.Counter()
        self._fail_ordinals = frozenset(schedule.upload_fail_ordinals)
        self._poison_left = {
            i: spec.count for i, spec in enumerate(schedule.poison)
        }
        self._kill_armed = schedule.kill_after_windows is not None

    # seam: ResidencyManager.fault_hook, called on every chunk-build miss
    def on_upload(self, key) -> None:
        ordinal = self.upload_attempts
        self.upload_attempts += 1
        if ordinal in self._fail_ordinals:
            self.injected["upload_fail"] += 1
            raise TransientFault(
                f"injected upload failure (build ordinal {ordinal}, key={key})"
            )

    # seam: staged chunk pixels, before verification
    def corrupt_chunk(
        self, start: int, stop: int, pixels: np.ndarray
    ) -> np.ndarray:
        """Return ``pixels`` with scheduled corruption applied (on a copy —
        the host seqfile stays clean, which is what makes retry heal)."""
        out = None
        for i, spec in enumerate(self.schedule.poison):
            if not start <= spec.pack < stop:
                continue
            left = self._poison_left[i]
            if left is not None and left <= 0:
                continue
            if out is None:
                out = np.array(pixels, copy=True)
            row = out[spec.pack - start]
            if spec.mode == "nan":
                row.reshape(-1)[0] = np.nan
            elif spec.mode == "inf":
                row.reshape(-1)[0] = np.inf
            elif spec.mode == "flip":
                row += 1.0
            else:
                raise ValueError(f"unknown poison mode {spec.mode!r}")
            if left is not None:
                self._poison_left[i] = left - 1
            self.injected["poison"] += 1
        return pixels if out is None else out

    # seam: window execution (inside the tracker's timed region)
    def on_window_execute(self, win) -> None:
        ordinal = self.window_execs
        self.window_execs += 1
        slow_s = self.schedule.slow_windows.get(ordinal)
        if slow_s:
            self.injected["slow"] += 1
            time.sleep(slow_s)

    # seam: window completion (after the partial is journaled)
    def on_window_complete(self, win) -> None:
        self.windows_completed += 1
        if (
            self._kill_armed
            and self.windows_completed >= self.schedule.kill_after_windows
        ):
            # Fire once: the resumed query must replay, not die again.
            self._kill_armed = False
            self.injected["kill"] += 1
            raise QueryKilled(
                f"injected kill after {self.windows_completed} windows"
            )


__all__ = [
    "ChaosInjector",
    "DeterminismError",
    "FatalFault",
    "FaultError",
    "FaultSchedule",
    "PoisonSpec",
    "PoisonedChunkError",
    "QueryKilled",
    "TransientFault",
    "classify",
]
