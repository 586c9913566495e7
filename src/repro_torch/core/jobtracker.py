"""Brick materialization as tracked, retryable tasks (DESIGN.md §9).

Counterpart of the brick half of ``repro.core.jobtracker``.  The coadd
job's work is split into idempotent tasks whose outputs combine through a
commutative monoid, so any task may be re-executed without changing the
result (paper §3: at cluster scale failures are the norm).  Here a task is
one (brick, band) cell of `CoaddEngine.materialize_bricks`; the retry
policy is `faults.classify`.  The streaming `WindowTracker`, the image-shard
`JobTracker` and `partial_digest` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence

from repro_torch.core.faults import classify


@dataclasses.dataclass
class BrickTask:
    """One (brick, band) cell of a materialization job, with its outcome."""

    band: str
    row: int
    col: int
    status: str = "pending"   # pending | done | partial | skipped
    attempts: int = 0
    packs_scanned: int = 0
    retries: int = 0          # window-level retries inside the brick's query
    resumed_windows: int = 0  # journal replays (a resumed killed brick)


@dataclasses.dataclass
class MaterializeReport:
    """What a `materialize_bricks` call did, per task and in aggregate."""

    tasks: List[BrickTask]

    @property
    def completed(self) -> int:
        return sum(t.status in ("done", "partial") for t in self.tasks)

    @property
    def skipped(self) -> int:
        return sum(t.status == "skipped" for t in self.tasks)

    @property
    def partial_bricks(self) -> int:
        return sum(t.status == "partial" for t in self.tasks)


class MaterializeTracker:
    """Drives brick materialization as journaled, retryable tasks.

    Each (brick, band) cell is one idempotent task; its output lands in the
    `BrickStore`, which doubles as the completion journal: ``is_done``
    consults it, so a killed job resumes by skipping finished bricks.
    Transient faults consume attempts with capped exponential backoff;
    fatal faults, above all `QueryKilled`, escape immediately and leave the
    store in place for the resume.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.max_attempts = max(max_attempts, 1)
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self._sleep = sleep
        self.events: List[str] = []

    def run(
        self,
        tasks: Sequence[BrickTask],
        is_done: Callable[[BrickTask], bool],
        run_one: Callable[[BrickTask], None],
    ) -> List[BrickTask]:
        tasks = list(tasks)
        for task in tasks:
            if is_done(task):
                task.status = "skipped"
                self.events.append(
                    f"journal-hit brick=({task.band},{task.row},{task.col})"
                )
                continue
            attempt = 0
            while True:
                attempt += 1
                task.attempts = attempt
                try:
                    run_one(task)
                    break
                except Exception as e:  # noqa: PERF203
                    if classify(e) == "fatal":
                        raise
                    self.events.append(
                        f"retry brick=({task.band},{task.row},{task.col}) "
                        f"attempt={attempt}: {e}"
                    )
                    if attempt >= self.max_attempts:
                        raise
                    self._sleep(
                        min(self.backoff_s * (2 ** (attempt - 1)),
                            self.backoff_cap_s)
                    )
        return tasks


__all__ = ["BrickTask", "MaterializeReport", "MaterializeTracker"]
