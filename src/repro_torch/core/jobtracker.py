"""Trackers: Hadoop-style task re-execution, speculation and journaling.

Counterpart of ``repro.core.jobtracker``.  MapReduce's scaling premise
(paper §3): at thousands of nodes failures are the norm, and the framework
hides them by re-executing failed tasks and launching redundant
("speculative") copies of stragglers.  The work is split into idempotent,
journaled tasks whose outputs combine through a commutative monoid (coadd
accumulation), so any task may be re-executed, or executed twice, without
changing the result:

* task completion is journaled; a restart replays only missing tasks;
* stragglers get speculative backups: first result wins, and the digests
  of the two must agree (the determinism check);
* retries tell transient from fatal errors (`faults.classify`): transient
  failures back off exponentially (capped) and re-execute, fatal ones,
  above all `DeterminismError`, escape at once.

Three trackers share that contract:

* `JobTracker`: the host-level API over explicit image-id shards
  (`MapTask`), for elastic repartitioning;
* `WindowTracker`: the streaming engine's fault domain (DESIGN.md §8).
  Each `ScanWindow` of a streamed query is one task; the tracker owns
  retry, speculation, poison quarantine and the window journal that a
  resumed query replays.  The engine hands it the device work through
  callbacks and keeps the partials on the card: a journal holds each
  window's partial as a host copy (``stage``), and the tracker sums the
  partials through the engine's in-place ``accumulate``;
* `MaterializeTracker`: brick materialization, one task a (brick, band).
"""

from __future__ import annotations

import dataclasses
import hashlib
import statistics
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.core.faults import (
    DeterminismError,
    PoisonedChunkError,
    QueryKilled,
    classify,
)


@dataclasses.dataclass
class MapTask:
    task_id: int
    image_ids: np.ndarray  # the shard of images this task maps


@dataclasses.dataclass
class TaskResult:
    task_id: int
    coadd: np.ndarray
    depth: np.ndarray
    digest: str
    attempts: int
    worker: int


def _digest(coadd: np.ndarray, depth: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(coadd, np.float32).tobytes())
    h.update(np.ascontiguousarray(depth, np.float32).tobytes())
    return h.hexdigest()[:16]


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def partial_digest(parts) -> str:
    """Content digest of a window's partial-accumulator tuple.

    The idempotency token of a window task: speculation re-executes the
    window and demands digest agreement.  Copies device tensors to the host
    (a sync) and hashes the same bytes as the reference, so equal arrays
    give equal digests in both packages; which is why the tracker digests
    only when it must, never on the clean streaming path.
    """
    h = hashlib.sha256()
    for p in parts:
        h.update(np.ascontiguousarray(_host(p)).tobytes())
    return h.hexdigest()[:16]


class FailureInjector:
    """Deterministic failure/straggler schedule for the legacy JobTracker.

    fail_plan: {(task_id, attempt): kind} with kind one of ``"fail"``
    (RuntimeError — transient by policy), ``"fail_transient"``/``"fail_os"``
    (other transient types; the retry net must catch them too), ``"fail_fatal"``
    (ValueError — must escape), or ``"slow"`` (sleep ``slow_s``).
    """

    _KINDS = {
        "fail": RuntimeError,
        "fail_transient": ConnectionError,
        "fail_os": OSError,
        "fail_fatal": ValueError,
    }

    def __init__(self, plan: Optional[Dict] = None, slow_s: float = 0.0):
        self.plan = plan or {}
        self.slow_s = slow_s

    def before_run(self, task_id: int, attempt: int):
        kind = self.plan.get((task_id, attempt))
        if kind is None:
            return
        if kind == "slow":
            if self.slow_s:
                time.sleep(self.slow_s)
            return
        exc = self._KINDS.get(kind)
        if exc is None:
            raise ValueError(f"unknown injection kind {kind!r}")
        raise exc(f"injected {kind}: task {task_id} attempt {attempt}")


class JobTracker:
    """Executes map tasks with journaling, retry, and speculative backup.

    ``executor(image_ids) -> (coadd, depth)`` (arrays or tensors) must be
    deterministic in its inputs, which the tracker *verifies* when
    speculation produces two results for one task.
    """

    def __init__(
        self,
        executor: Callable[[np.ndarray], tuple],
        n_workers: int = 4,
        max_attempts: int = 3,
        straggler_threshold_s: float = float("inf"),
        injector: Optional[FailureInjector] = None,
    ):
        self.executor = executor
        self.n_workers = n_workers
        self.max_attempts = max_attempts
        self.straggler_threshold_s = straggler_threshold_s
        self.injector = injector or FailureInjector()
        self.journal: Dict[int, TaskResult] = {}
        self.events: List[str] = []

    @staticmethod
    def split(image_ids: np.ndarray, n_tasks: int) -> List[MapTask]:
        """Location-free task partition (supports elastic re-partitioning)."""
        chunks = np.array_split(np.asarray(image_ids), n_tasks)
        return [MapTask(i, c) for i, c in enumerate(chunks) if len(c)]

    def _attempt(self, task: MapTask, attempt: int, worker: int) -> TaskResult:
        self.injector.before_run(task.task_id, attempt)
        t0 = time.perf_counter()
        coadd, depth = self.executor(task.image_ids)
        dt = time.perf_counter() - t0
        res = TaskResult(task.task_id, _host(coadd), _host(depth), "", attempt, worker)
        res.digest = _digest(res.coadd, res.depth)
        if dt > self.straggler_threshold_s:
            # Straggler: speculative backup on another worker; first-completed
            # semantics — here sequential, so verify digests agree instead.
            self.events.append(f"speculative task={task.task_id}")
            backup = self.executor(task.image_ids)
            bd = _digest(_host(backup[0]), _host(backup[1]))
            if bd != res.digest:
                raise DeterminismError(
                    f"nondeterministic task {task.task_id}: {res.digest} != {bd}"
                )
        return res

    def run(self, tasks: Sequence[MapTask]) -> tuple:
        """Run all tasks (skipping journaled ones), return combined coadd."""
        for ti, task in enumerate(tasks):
            if task.task_id in self.journal:
                self.events.append(f"journal-hit task={task.task_id}")
                continue
            worker = ti % self.n_workers
            for attempt in range(self.max_attempts):
                try:
                    res = self._attempt(task, attempt, worker)
                    self.journal[task.task_id] = res
                    break
                except Exception as e:  # noqa: PERF203
                    # Transient-vs-fatal split (faults.classify): only
                    # transient failures consume a retry; nondeterminism and
                    # other fatal errors escape — re-rolling them is wrong.
                    if classify(e) == "fatal":
                        raise
                    self.events.append(
                        f"retry task={task.task_id} attempt={attempt}: {e}"
                    )
                    worker = (worker + 1) % self.n_workers  # reschedule elsewhere
            else:
                raise RuntimeError(f"task {task.task_id} exhausted retries")
        # Commutative-monoid combine: order-independent.
        results = [self.journal[t.task_id] for t in tasks]
        coadd = np.sum([r.coadd for r in results], axis=0)
        depth = np.sum([r.depth for r in results], axis=0)
        return coadd, depth


# ----- streaming window fault domain (DESIGN.md §8) -----
@dataclasses.dataclass
class FaultCounters:
    """Per-query fault accounting, threaded into JobStats by the engine."""

    retries: int = 0              # failed attempts that were re-executed
    speculative_windows: int = 0  # straggler backups launched (and verified)
    quarantined_packs: int = 0    # packs gated out after persistent poison
    resumed_windows: int = 0      # journal hits replayed instead of re-run


def _block(parts):
    """Host-block on a partial tuple (speculation needs wall-clock truth):
    on a CUDA device, wait for an event recorded after it on the current
    stream of the thread that computed it; on the host, nothing to wait."""
    for p in parts:
        if isinstance(p, torch.Tensor) and p.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(p.device))
            done.synchronize()
            break
    return parts


class WindowTracker:
    """Runs a window schedule as idempotent, journaled, retryable tasks.

    The streaming executors hand every `ScanWindow` through here (when
    ``on_fault != "raise"``); the tracker owns the fault policy, the engine
    owns the device work via two callbacks:

    * ``acquire(win, quarantined) -> operands`` — make the window's chunk
      resident (the upload seam; raises on injected or real upload failures
      and on a digest mismatch);
    * ``dispatch(operands, win, quarantined) -> partials`` — launch the
      window's scan (asynchronous; the partial tuple stays on the device).
      It may raise `PoisonedChunkError`: the engine reads a chunk's
      non-finite flags just before its first scan.

    The next window's chunk is acquired before this window is dispatched,
    so its upload overlaps this scan (the double buffer).  Clean-path cost
    is one dict lookup and one journal insert a window: no digests, no
    syncs, no timing, so the one-sync-at-reduce-time contract (DESIGN.md
    §6) holds.  Enabling speculation (``straggler_factor``) is the
    documented exception: timing a window means blocking on it, so wall
    clock degrades to sum-of-windows in exchange for straggler detection.
    """

    def __init__(
        self,
        policy: str = "retry",
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        straggler_factor: Optional[float] = None,
        straggler_min_windows: int = 2,
        injector=None,
        sleep: Callable[[float], None] = time.sleep,
        quarantined: Optional[Iterable[int]] = None,
        concurrent_speculation: bool = True,
    ):
        if policy not in ("retry", "quarantine", "raise"):
            raise ValueError(
                f"policy must be 'retry', 'quarantine', or 'raise'; got {policy!r}"
            )
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.policy = policy
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.straggler_factor = straggler_factor
        self.straggler_min_windows = straggler_min_windows
        self.injector = injector
        self._sleep = sleep
        # Concurrent speculation (§8): straggler backups run on a worker
        # thread so the main loop proceeds to the next window while the
        # backup re-executes; digest agreement is checked when the backups
        # drain at the end of the run.  False runs the backup inline,
        # serialized behind its primary.
        self.concurrent_speculation = concurrent_speculation
        self.counters = FaultCounters()
        self.events: List[str] = []
        self.durations: List[float] = []
        # Pre-quarantined packs (e.g. the engine's persistent registry,
        # released only by `ResidencyManager.reverify_quarantined`): they
        # gate out from window zero and report as uncovered, but only
        # *fresh* quarantines count in ``counters.quarantined_packs``.
        self.quarantined: Set[int] = set(quarantined or ())
        self._backups: List[Dict] = []

    def _backoff(self, attempt: int) -> None:
        self._sleep(min(self.backoff_s * (2 ** (attempt - 1)), self.backoff_cap_s))

    def run(self, windows, acquire, dispatch, journal: Dict, stage=None, load=None,
            accumulate=None) -> tuple:
        """Execute ``windows``; return ``(partials, sorted quarantined packs)``.

        ``journal`` maps ``win.key -> journal value`` and belongs to the
        caller: completed windows are written through as they finish (each
        commit deferred one window so it overlaps the successor's compute),
        and a `QueryKilled` (or any fatal error) still leaves every
        finished window journaled — a rerun with the same journal replays
        only the missing ones (``resumed_windows`` counts the hits).

        ``stage(part)`` makes a finished window's journal value, right after
        its dispatch and before ``accumulate`` may modify the partial (the
        engine enqueues a copy into pinned host memory); ``load(value)``
        turns a journal hit back into a partial; ``accumulate(acc, part)``
        adds a partial to the running sums (the engine adds in place).
        Defaults: the partial itself, and a fresh tuple of sums.
        """
        stage = stage or (lambda part: part)
        load = load or (lambda value: value)
        accumulate = accumulate or (lambda a, p: tuple(x + y for x, y in zip(a, p)))
        acc = None
        prefetched: Dict = {}
        pending = None  # (win, journal value) committed once the next window is live

        def flush(seam: bool) -> None:
            # Commit the held partial.  ``seam`` gates the injector's
            # kill-after-journaling hook: on the unwind path a fatal is
            # already in flight, so only the journal write happens.
            nonlocal pending
            if pending is None:
                return
            pwin, ppart = pending
            pending = None
            journal[pwin.key] = ppart
            if seam and self.injector is not None:
                # After journaling: an injected kill loses no finished work.
                self.injector.on_window_complete(pwin)

        try:
            try:
                for i, win in enumerate(windows):
                    key = win.key
                    if key in journal:
                        flush(True)
                        part = load(journal[key])
                        self.counters.resumed_windows += 1
                        self.events.append(f"journal-hit window={key}")
                        self._prefetch(i, windows, journal, acquire,
                                       prefetched)
                    else:
                        # Software pipeline: the next chunk's upload starts
                        # before this window's scan is enqueued, and the
                        # previous window commits after it, so a disk
                        # journal's wait overlaps this window's compute
                        # instead of serializing the stream.  This window's
                        # own commit waits until the next one is dispatched
                        # (or the loop/unwind flush below).
                        part = self._run_window(
                            win, acquire, dispatch, prefetched.pop(key, None),
                            before=lambda i=i: self._prefetch(
                                i, windows, journal, acquire, prefetched),
                        )
                        staged = stage(part)
                        flush(True)
                        pending = (win, staged)
                    acc = part if acc is None else accumulate(acc, part)
                    del part  # not held beside the next window's output
                flush(True)
            finally:
                # A fatal above must not lose a finished-but-uncommitted
                # window: the resume contract is that every completed
                # window is journaled when the query dies.
                flush(False)
        finally:
            # Join in-flight backups even when a fatal error escapes: their
            # threads read shared engine state and must retire first.
            backups, self._backups = self._backups, []
            for rec in backups:
                rec["thread"].join()
        self._verify_backups(backups)
        return acc, sorted(self.quarantined)

    def _prefetch(self, i, windows, journal, acquire, prefetched) -> None:
        """Double buffer: start the next chunk's async upload now.

        The operands are carried so the window doesn't re-acquire; the
        prefetch is opportunistic — a failure surfaces when the window
        itself runs (fatal errors re-raise there too), though a consumed
        transient attempt still counts as a retry.
        """
        if (i + 1 >= len(windows) or windows[i + 1].key in journal
                or windows[i + 1].key in prefetched):
            return
        nxt = windows[i + 1]
        try:
            prefetched[nxt.key] = acquire(nxt, frozenset(self.quarantined))
        except Exception as e:
            if classify(e) == "transient":
                self.counters.retries += 1
            self.events.append(f"prefetch-fault window={nxt.key}: {e}")

    def _verify_backups(self, backups: List[Dict]) -> None:
        """Enforce digest agreement for drained concurrent backups.

        A backup that failed transiently gets one inline re-execution (its
        purpose is the determinism proof, so it must actually produce a
        digest); fatal errors — and disagreement — escape as ever.
        """
        for rec in backups:
            err = rec.get("error")
            if err is not None:
                if classify(err) == "fatal":
                    raise err
                self.counters.retries += 1
                self.events.append(
                    f"backup-retry window={rec['win'].key}: {err}"
                )
                backup = _block(
                    rec["dispatch"](rec["ops"], rec["win"], rec["drop"])
                )
                rec["digest"] = partial_digest(backup)
            if rec["digest"] != rec["primary_digest"]:
                raise DeterminismError(
                    f"window {rec['win'].key}: primary digest "
                    f"{rec['primary_digest']} != backup {rec['digest']}"
                )

    def _run_window(self, win, acquire, dispatch, ops=None, before=None):
        """One window to its partial, under the retry, quarantine and
        speculation policy.  ``before()`` runs once, after the window's
        chunk is first acquired and before its first dispatch (the
        prefetch of the next chunk)."""
        attempt = 0
        while True:
            attempt += 1
            try:
                if ops is None:
                    ops = acquire(win, frozenset(self.quarantined))
                if before is not None:
                    before()
                    before = None
                t0 = time.perf_counter()
                if self.injector is not None:
                    self.injector.on_window_execute(win)  # straggler seam
                part = dispatch(ops, win, frozenset(self.quarantined))
                if self.straggler_factor is not None:
                    part = _block(part)
                    dt = time.perf_counter() - t0
                    self._maybe_speculate(win, ops, dispatch, part, dt)
                    self.durations.append(dt)
                return part
            except QueryKilled:
                raise
            except PoisonedChunkError as e:
                ops = None  # re-acquire: the staged chunk was rejected
                self.counters.retries += 1
                self.events.append(
                    f"poison window={win.key} attempt={attempt}: {e}"
                )
                if attempt < self.max_attempts:
                    self._backoff(attempt)
                    continue
                if self.policy == "quarantine":
                    fresh = set(e.packs) - self.quarantined
                    if not fresh:
                        # Quarantining can't make progress: the chunk fails
                        # verification on packs already gated out.
                        raise
                    self.quarantined |= fresh
                    self.counters.quarantined_packs += len(fresh)
                    self.events.append(f"quarantine packs={sorted(fresh)}")
                    attempt = 0  # the sanitized chunk gets fresh attempts
                    continue
                raise
            except Exception as e:
                if classify(e) == "fatal":
                    raise
                ops = None  # re-acquire on retry (a hit if the chunk landed)
                self.counters.retries += 1
                self.events.append(
                    f"retry window={win.key} attempt={attempt}: {e}"
                )
                if attempt >= self.max_attempts:
                    raise
                self._backoff(attempt)

    def _maybe_speculate(self, win, ops, dispatch, part, dt: float) -> None:
        if len(self.durations) < self.straggler_min_windows:
            return
        median = statistics.median(self.durations)
        if median <= 0 or dt <= self.straggler_factor * median:
            return
        # Straggler: launch a backup execution of the same window.  First
        # result wins (the primary already finished); the backup exists to
        # prove the task is re-executable — digests must agree.
        self.counters.speculative_windows += 1
        self.events.append(
            f"speculative window={win.key} dt={dt:.4f}s median={median:.4f}s"
        )
        drop = frozenset(self.quarantined)
        if not self.concurrent_speculation:
            backup = _block(dispatch(ops, win, drop))
            d0, d1 = partial_digest(part), partial_digest(backup)
            if d0 != d1:
                raise DeterminismError(
                    f"window {win.key}: primary digest {d0} != backup {d1}"
                )
            return
        # Concurrent: the backup dispatch runs on a worker thread while the
        # main loop moves on to later windows — a slow primary no longer
        # serializes its own backup.  Digest agreement is enforced when the
        # run drains (`_verify_backups`); the digest of the primary is taken
        # now, while ``part`` is known-final.
        rec: Dict = {
            "win": win, "ops": ops, "dispatch": dispatch, "drop": drop,
            "primary_digest": partial_digest(part), "digest": None,
        }

        def _backup() -> None:
            try:
                rec["digest"] = partial_digest(_block(dispatch(ops, win, drop)))
            except BaseException as e:  # joined + reclassified at drain
                rec["error"] = e

        rec["thread"] = threading.Thread(
            target=_backup, name=f"backup-{win.key}", daemon=True
        )
        self._backups.append(rec)
        rec["thread"].start()


# ----- brick materialization as tracked tasks (DESIGN.md §9) -----
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


__all__ = [
    "BrickTask",
    "FailureInjector",
    "FaultCounters",
    "JobTracker",
    "MapTask",
    "MaterializeReport",
    "MaterializeTracker",
    "TaskResult",
    "WindowTracker",
    "partial_digest",
]
