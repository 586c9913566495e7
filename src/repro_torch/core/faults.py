"""Fault taxonomy (DESIGN.md §8): which failures are retried, which escape.

Counterpart of the taxonomy half of ``repro.core.faults``.  At cluster
scale failures are the norm (paper §3); the framework hides transient
faults by re-executing and lets fatal ones escape.  `classify` is that
policy: transient errors are retried with capped exponential backoff by the
trackers (`jobtracker.MaterializeTracker`), fatal errors escape at once.
The split is deliberate policy, not exception pedigree: device and transfer
failures surface as bare ``RuntimeError``, so that type is transient by
default, while `DeterminismError` (two executions of one task disagreeing)
must never be retried.  The chaos harness (``FaultSchedule``,
``ChaosInjector``, ``PoisonSpec``) is not ported yet.
"""

from __future__ import annotations

from typing import Iterable



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


__all__ = [
    "DeterminismError",
    "FatalFault",
    "FaultError",
    "PoisonedChunkError",
    "QueryKilled",
    "TransientFault",
    "classify",
]
