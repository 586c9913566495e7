"""Durable journals: crash-safe window partials and a persistent brick spill.

Counterpart of ``repro.core.durable``; host-only, so a copy.  Hadoop's
robustness (paper §3) comes from materializing intermediate task outputs to
worker-local disk: losing a process, not just a task, loses no finished
work.  The in-memory window journal survives a failed query but not the
process; this module is the disk half of that contract (DESIGN.md §8):

* `JournalStore` / `DiskJournal`: per-job append-only journals of window
  partials.  Each job key owns a directory holding a `segment.bin` of raw
  npy payload records and a `manifest.jsonl` with one line per committed
  record (window key, byte range, sha256).  A record is committed by
  appending its payload bytes and *then* its manifest line (each flushed to
  the OS), so a crash at any byte leaves either a fully committed record or
  an ignorable tail.  Replay walks the manifest, stops at the first invalid
  record (truncated line, out-of-range payload, or digest mismatch) and
  truncates both files back to that valid prefix: a corrupted tail degrades
  to re-execution, never to a crash or a wrong bit.

* `BrickSpill`: the persistent host tier of the `BrickStore`, one
  atomically renamed npz per brick carrying its own content digest.  Reload
  verifies the digest; any failure (torn write, bit flip, truncation)
  deletes the file and reports a miss, so the brick simply rematerializes.

The engine opts in with ``CoaddEngine(journal_dir=...)``; the in-memory
default keeps its one-sync clean path.  The engine hands a journal host
arrays: a window's partial copied into pinned host memory on the compute
stream, waited on (its event, not the device) one window late.  Commits are
synchronous but flush-only: each record lands in the page cache (durable
across process death, the SIGKILL drills' failure model), and the fsync
pair is deferred to the ``drain`` barrier the engine runs on the fatal
path, narrowing the *power-loss* window to the tail of a query instead of
paying an fsync per record.

Crash-drill seam: `set_crash_hook` installs a callable invoked with a stage
name at every durability boundary (``payload_mid``, ``payload_done``,
``manifest_done``, ``brick_done``).  A drill whose hook SIGKILLs its own
process there (mid segment write included) shows that a fresh process
resumes bitwise.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# Stages, in commit order, at which `_crash` fires (see module docstring).
CRASH_STAGES = ("payload_mid", "payload_done", "manifest_done", "brick_done")

_CRASH_HOOK: Optional[Callable[[str], None]] = None


def set_crash_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the crash-drill hook.

    Test-only seam: the hook runs inside the durability commit sequence, so
    a hook that SIGKILLs its own process models a crash at exactly that
    boundary.  Production never sets it; the clean-path cost is one global
    load per stage.
    """
    global _CRASH_HOOK
    _CRASH_HOOK = hook


def _crash(stage: str) -> None:
    if _CRASH_HOOK is not None:
        _CRASH_HOOK(stage)


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a just-renamed/created entry survives power loss.

    Best-effort: some filesystems refuse O_RDONLY on directories; the rename
    itself is still atomic there, only its durability window widens.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_bytes(path: Path, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` via temp file + fsync + atomic rename.

    ``fsync=False`` skips both fsyncs for *advisory* files (e.g. a job's
    ``meta.json``): the rename stays atomic — the file is never torn — but
    its durability window widens to the next OS writeback.
    """
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path.parent)


def _encode_arrays(arrays: Tuple[np.ndarray, ...]) -> bytes:
    """One blob for a window's partial-accumulator tuple.

    A raw npy stream — count byte, then each array in `numpy.lib.format` —
    rather than npz: the zip container costs ~0.4 ms per record on the
    journal's hot path and buys nothing (the manifest already carries the
    sha256; names and compression don't apply to a 3-tuple of partials).
    """
    bio = io.BytesIO()
    bio.write(bytes([len(arrays)]))
    for a in arrays:
        np.lib.format.write_array(
            bio, np.asarray(a), allow_pickle=False
        )
    return bio.getvalue()


def _decode_arrays(data: bytes) -> Tuple[np.ndarray, ...]:
    bio = io.BytesIO(data)
    n = bio.read(1)[0]
    return tuple(
        np.lib.format.read_array(bio, allow_pickle=False) for _ in range(n)
    )


class DiskJournal:
    """One job's on-disk window journal (dict-like; see `WindowTracker.run`).

    Keys are window keys — tuples of ints ``(start, stop, n_gated,
    budget)`` — and values are window partial tuples of host arrays (the
    engine waits on a partial's copy event before it commits one).
    `__setitem__` *commits* the partial: payload append +
    flush, then manifest line + flush.  A flush makes the record durable
    against process death (SIGKILL, OOM — the page cache survives); the
    fsync pair that makes it durable against power loss is deferred to the
    `drain` barrier, which the engine runs on the fatal path (the moment an
    orphaned journal starts to matter).  A record lost to an unsynced
    power cut just tears the tail — replay truncates back to the valid
    prefix and the windows re-execute.

    Commit errors (disk full, permissions) are recorded in ``error`` and
    the record stays in-memory only: a broken journal downgrades
    durability, never the answer.

    Opening replays the valid manifest prefix and truncates any invalid
    tail of both files, so an instance is always consistent with its disk
    state; ``dropped_records`` counts records a corrupted tail discarded.
    """

    SEGMENT = "segment.bin"
    MANIFEST = "manifest.jsonl"

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._seg_path = self.root / self.SEGMENT
        self._man_path = self.root / self.MANIFEST
        self._entries: Dict[Tuple[int, ...], Tuple[np.ndarray, ...]] = {}
        self._seg_f = None
        self._man_f = None
        self.error: Optional[BaseException] = None
        self.dropped_records = 0
        self._replay()

    # ----- replay: valid prefix only, truncate the rest -----
    def _replay(self) -> None:
        if not self._man_path.exists():
            self._seg_end = 0
            if self._seg_path.exists():
                # Manifest lost/never written: nothing is committed.
                self._truncate(self._seg_path, 0)
            return
        seg = self._seg_path.read_bytes() if self._seg_path.exists() else b""
        man_valid = seg_valid = 0
        with open(self._man_path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # torn final line: not committed
                try:
                    rec = json.loads(raw)
                    key = tuple(int(k) for k in rec["win"])
                    off, ln = int(rec["off"]), int(rec["len"])
                    sha = rec["sha"]
                except (ValueError, KeyError, TypeError):
                    break
                if off != seg_valid or off + ln > len(seg):
                    break  # gap or truncated payload
                payload = seg[off:off + ln]
                if hashlib.sha256(payload).hexdigest() != sha:
                    break  # bit rot in the payload (or a stale manifest)
                try:
                    self._entries[key] = _decode_arrays(payload)
                except Exception:
                    break  # undecodable despite digest: stale format
                man_valid += len(raw)
                seg_valid = off + ln
        self.dropped_records = max(
            self._count_lines(self._man_path) - len(self._entries), 0
        )
        # Truncate both files to the committed prefix so appends restart
        # from a consistent byte offset.
        self._truncate(self._man_path, man_valid)
        self._truncate(self._seg_path, seg_valid)
        self._seg_end = seg_valid

    @staticmethod
    def _count_lines(path: Path) -> int:
        try:
            with open(path, "rb") as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    @staticmethod
    def _truncate(path: Path, size: int) -> None:
        if path.exists() and path.stat().st_size > size:
            with open(path, "r+b") as f:
                f.truncate(size)
                f.flush()
                os.fsync(f.fileno())

    # ----- append path -----
    def _files(self):
        if self._seg_f is None:
            self._seg_f = open(self._seg_path, "ab")
            self._man_f = open(self._man_path, "ab")
        return self._seg_f, self._man_f

    def __setitem__(self, key, parts) -> None:
        norm = tuple(int(k) for k in key)
        host = tuple(np.asarray(p) for p in parts)  # host arrays: no device sync
        try:
            self._commit(norm, host)
        except BaseException as e:
            self.error = e  # durability lost; the entry stays in-memory
        self._entries[norm] = host

    def _commit(self, key: Tuple[int, ...],
                host: Tuple[np.ndarray, ...]) -> None:
        payload = _encode_arrays(host)
        sha = hashlib.sha256(payload).hexdigest()
        seg_f, man_f = self._files()
        off = self._seg_end
        half = len(payload) // 2
        seg_f.write(payload[:half])
        seg_f.flush()
        _crash("payload_mid")  # a crash here leaves an uncommitted tail
        seg_f.write(payload[half:])
        seg_f.flush()
        _crash("payload_done")  # payload flushed, record not yet committed
        line = json.dumps(
            {"win": list(key), "off": off, "len": len(payload), "sha": sha}
        )
        man_f.write(line.encode() + b"\n")
        man_f.flush()
        self._seg_end = off + len(payload)
        _crash("manifest_done")  # record committed (process-death durable)

    def drain(self) -> None:
        """The power-loss durability barrier: fsync both files.

        Per-record commits only flush (cheap, survives process death); the
        engine drains on the fatal path — the one moment an orphaned
        journal is about to become load-bearing — so everything committed
        before the fault also survives a machine crash.
        """
        for f in (self._seg_f, self._man_f):
            if f is not None:
                try:
                    f.flush()
                    os.fsync(f.fileno())
                except OSError as e:  # pragma: no cover - defensive
                    self.error = e

    # ----- dict-like reads (the tracker's journal contract) -----
    def __contains__(self, key) -> bool:
        return tuple(int(k) for k in key) in self._entries

    def __getitem__(self, key):
        return self._entries[tuple(int(k) for k in key)]

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> Iterator[Tuple[int, ...]]:
        return iter(self._entries)

    def close(self) -> None:
        for f in (self._seg_f, self._man_f):
            if f is not None:
                f.close()
        self._seg_f = self._man_f = None


class JournalStore:
    """Directory of `DiskJournal`s keyed by job key, with GC.

    Layout: ``root/<job_key[:32]>/{meta.json, segment.bin, manifest.jsonl}``.
    ``meta.json`` (atomic-rename write) records the full job key and
    creation time.  `remove` retires a completed job atomically: the
    directory is renamed aside first, so a crash mid-delete never leaves a
    half-journal a resume could misread.  `sweep_stale` (run at engine
    init) deletes orphans older than ``max_age_s`` plus any rename/temp
    debris — completed jobs remove their journals, so orphans are only
    crashed jobs nobody resumed.
    """

    def __init__(self, root, max_age_s: float = 7 * 86400.0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_age_s = float(max_age_s)
        self._tomb_seq = 0
        self._reaper: Optional[threading.Thread] = None
        self._tombs: "queue.Queue" = queue.Queue()
        self.swept = self.sweep_stale()

    def _job_dir(self, job_key: str) -> Path:
        return self.root / job_key[:32]

    def exists(self, job_key: str) -> bool:
        return (self._job_dir(job_key) / DiskJournal.MANIFEST).exists()

    def open(self, job_key: str) -> DiskJournal:
        d = self._job_dir(job_key)
        journal = DiskJournal(d)
        meta = d / "meta.json"
        if not meta.exists():
            # Advisory, for humans inspecting the store: the dir name is
            # the identity and nothing machine-reads this, so a plain write
            # (torn on crash at worst) beats paying tmp+rename per query.
            meta.write_bytes(
                json.dumps(
                    {"job_key": job_key, "created": time.time()}
                ).encode()
            )
        return journal

    def remove(self, job_key: str) -> bool:
        """Atomically retire a job's journal (clean-exit GC).

        The rename is the retirement — one atomic step and the journal can
        never be resumed.  The actual deletion is handed to a background
        reaper thread so completion doesn't pay rmtree latency; a tomb that
        outlives the process is just debris the next `sweep_stale` eats.
        """
        d = self._job_dir(job_key)
        if not d.exists():
            return False
        self._tomb_seq += 1
        tomb = d.with_name(f"{d.name}.gc.{os.getpid()}.{self._tomb_seq}")
        try:
            os.rename(d, tomb)  # atomic: the journal vanishes in one step
        except OSError:
            return False
        self._tombs.put(tomb)
        if self._reaper is None or not self._reaper.is_alive():
            self._reaper = threading.Thread(
                target=self._reap, name="journal-reaper", daemon=True
            )
            self._reaper.start()
        return True

    def _reap(self) -> None:
        while True:
            try:
                tomb = self._tombs.get(timeout=5.0)
            except queue.Empty:
                return  # idle: let the thread retire; remove() respawns it
            shutil.rmtree(tomb, ignore_errors=True)
            self._tombs.task_done()

    def drain_tombs(self) -> None:
        """Block until every queued tomb has been deleted (test sync point)."""
        self._tombs.join()

    def jobs(self) -> List[str]:
        return sorted(
            p.name for p in self.root.iterdir()
            if p.is_dir() and ".gc." not in p.name
        )

    def sweep_stale(self, max_age_s: Optional[float] = None) -> int:
        """Delete orphan journals older than the age cap (+ any debris)."""
        cap = self.max_age_s if max_age_s is None else float(max_age_s)
        now = time.time()
        swept = 0
        for p in list(self.root.iterdir()):
            if ".gc." in p.name or ".tmp." in p.name:
                # Debris from an interrupted remove/atomic write.
                shutil.rmtree(p, ignore_errors=True)
                if not p.is_dir():
                    p.unlink(missing_ok=True)
                swept += 1
                continue
            if not p.is_dir():
                continue
            try:
                age = now - p.stat().st_mtime
            except OSError:
                continue
            if age > cap:
                shutil.rmtree(p, ignore_errors=True)
                swept += 1
        return swept


class BrickSpill:
    """Persistent, self-checksummed host spill for materialized bricks.

    One npz per brick key — coadd, depth, a json-encoded meta dict, and a
    sha256 over all three — written via temp file + fsync + atomic rename,
    so a file either exists whole or not at all.  `load` re-verifies the
    digest and treats *any* failure as a miss (deleting the bad file): a
    corrupted brick costs a rematerialization, never a crash or a wrong
    mosaic.
    """

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.corrupt_drops = 0  # reloads rejected by digest/decode failure

    def _path(self, key: Tuple) -> Path:
        tag = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
        return self.root / f"brick-{tag}.npz"

    @staticmethod
    def _digest(coadd: np.ndarray, depth: np.ndarray, meta_raw: bytes) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(coadd, np.float32).tobytes())
        h.update(np.ascontiguousarray(depth, np.float32).tobytes())
        h.update(meta_raw)
        return h.hexdigest()

    def save(self, key: Tuple, coadd: np.ndarray, depth: np.ndarray,
             meta: Dict) -> None:
        meta_raw = json.dumps(meta, sort_keys=True).encode()
        bio = io.BytesIO()
        np.savez(
            bio,
            coadd=np.asarray(coadd, np.float32),
            depth=np.asarray(depth, np.float32),
            meta=np.frombuffer(meta_raw, np.uint8),
            sha=np.frombuffer(
                self._digest(coadd, depth, meta_raw).encode(), np.uint8
            ),
            keyrepr=np.frombuffer(repr(key).encode(), np.uint8),
        )
        _atomic_write_bytes(self._path(key), bio.getvalue())
        _crash("brick_done")

    def load(
        self, key: Tuple
    ) -> Optional[Tuple[np.ndarray, np.ndarray, Dict]]:
        path = self._path(key)
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                coadd = np.asarray(z["coadd"], np.float32)
                depth = np.asarray(z["depth"], np.float32)
                meta_raw = z["meta"].tobytes()
                sha = z["sha"].tobytes().decode()
            if self._digest(coadd, depth, meta_raw) != sha:
                raise ValueError("digest mismatch")
            return coadd, depth, json.loads(meta_raw)
        except Exception:
            # Corrupt/truncated/unreadable: drop it and report a miss —
            # the caller rematerializes.
            self.corrupt_drops += 1
            path.unlink(missing_ok=True)
            return None

    def contains(self, key: Tuple) -> bool:
        return self._path(key).exists()

    def delete(self, key: Tuple) -> None:
        self._path(key).unlink(missing_ok=True)

    def clear(self) -> None:
        for p in self.root.glob("brick-*.npz"):
            p.unlink(missing_ok=True)


__all__ = [
    "CRASH_STAGES",
    "BrickSpill",
    "DiskJournal",
    "JournalStore",
    "set_crash_hook",
]
