"""Durable fault domain in the port (DESIGN.md §8): crash-safe journals, the
persistent brick store and process-death recovery, held against the JAX
package.

Ports ``tests/test_durable.py`` onto ``repro_torch`` (``device="cpu"``):

* **Unit**: `DiskJournal` / `JournalStore` / `BrickSpill` commit atomically,
  replay valid prefixes of corrupted files, and never report a record whose
  payload does not hash back to its manifest digest; the files the port
  writes are the reference's format (each package reads the other's).
* **In-process chaos**: a killed streamed query leaves an on-disk journal
  that a *fresh engine* resumes bitwise, even after the journal is
  truncated, bit-flipped or digest-mismatched under it; resumed counts and
  results as the reference's (depth exactly, coadd at atol 5e-2 / rtol
  1e-3, tests/test_streaming.py:129).
* **Process death**: this file run as a script is the worker
  (``python tests/test_torch_durable.py --journal-dir ... --out ...``; it
  stops before the test half's imports): it SIGKILLs itself at a seeded
  durable-commit stage (`durable.set_crash_hook`), and a restarted worker
  replays the journal and must match the uninterrupted run bitwise with
  ``resumed_windows > 0``.

The engines stream the reference drills' windows: chunks of two packs (one
for the brick store), the budget (2c + 1) packs, as tests/test_torch_faults.py
explains.  The reference marks slow the same cases this file does.
"""
import argparse
import json
import os
import signal
import sys

import numpy as np
import torch

import repro_torch as rt
from repro_torch.core import durable

SURVEY_KW = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
QUERY_KW = dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
BRICK_KW = dict(brick_deg=0.5, brick_npix=32)
ATOL, RTOL = 5e-2, 1e-3          # the reference's streaming tolerance


# ===== the drill engines, shared by the tests and the worker ================

def build_survey():
    return rt.make_survey(rt.SurveyConfig(**SURVEY_KW))


def build_query():
    return rt.CoaddQuery(**QUERY_KW)


def build_engine(survey, journal_dir=None, chunk_packs=2, **kw):
    """A streaming port engine of the drills: chunks of ``chunk_packs``
    packs at (2 chunk_packs + 1) packs of budget, fast backoff, optionally
    durable."""
    probe = rt.CoaddEngine(survey, pack_capacity=8, device="cpu")
    pack = probe.exec_dataset("structured")[0].pack_nbytes()
    return rt.CoaddEngine(survey, pack_capacity=8, device="cpu",
                          device_budget_bytes=(2 * chunk_packs + 1) * pack,
                          fault_backoff_s=1e-4, journal_dir=journal_dir, **BRICK_KW, **kw)


def build_ref_engine(survey, journal_dir=None, chunk_packs=2, **kw):
    """The reference engine streaming the same windows as `build_engine`."""
    import repro.core as rc
    probe = rc.CoaddEngine(survey, pack_capacity=8)
    pack = probe.exec_dataset("structured")[0].pack_nbytes()
    return rc.CoaddEngine(survey, pack_capacity=8, device_budget_bytes=(2 * chunk_packs + 1) * pack,
                          stream_chunk_packs=chunk_packs, fault_backoff_s=1e-4,
                          journal_dir=journal_dir, **BRICK_KW, **kw)


def install_crash(spec: str) -> None:
    """Arm SIGKILL at the Nth firing of a durable commit stage, ``spec`` =
    ``"<stage>:<ordinal>"`` with stage one of `durable.CRASH_STAGES`."""
    stage, ordinal = spec.rsplit(":", 1)
    ordinal = int(ordinal)
    if stage not in durable.CRASH_STAGES:
        raise SystemExit(f"unknown crash stage {stage!r}")
    seen = {"n": 0}

    def hook(s: str) -> None:
        if s != stage:
            return
        if seen["n"] == ordinal:
            os.kill(os.getpid(), signal.SIGKILL)
        seen["n"] += 1

    durable.set_crash_hook(hook)


def run_stream(journal_dir: str, method: str):
    eng = build_engine(build_survey(), journal_dir=journal_dir)
    res = eng.run(build_query(), method)
    stats = {"resumed_windows": res.stats.resumed_windows, "windows": res.stats.windows,
             "dispatches": res.stats.dispatches, "jobs_left": eng.journal_store.jobs()}
    return res.coadd, res.depth, stats


def run_bricks(journal_dir: str, method: str):
    eng = build_engine(build_survey(), journal_dir=journal_dir)
    report = eng.materialize_bricks(bands=("r",), method=method)
    wq = eng.brick_grid.window_query(0, 2, 0, 2, "r")
    res = eng.run(wq, method, use_bricks=True)
    stats = {"resumed_windows": sum(t.resumed_windows for t in report.tasks),
             "completed": report.completed, "skipped": report.skipped,
             "n_bricks": len(report.tasks), "disk_loads": eng.brick_store.disk_loads,
             "bricks_served": res.stats.bricks_hit + res.stats.bricks_spilled,
             "jobs_left": eng.journal_store.jobs()}
    return res.coadd, res.depth, stats


def worker(argv=None) -> int:
    """The crash-restart drills' subprocess."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--journal-dir", required=True)
    ap.add_argument("--out", required=True, help="npz output path")
    ap.add_argument("--mode", choices=("stream", "bricks"), default="stream")
    ap.add_argument("--method", default="sql_structured")
    ap.add_argument("--crash", default=None, help="stage:ordinal SIGKILL seed")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.crash:
        install_crash(args.crash)
    runner = run_stream if args.mode == "stream" else run_bricks
    coadd, depth, stats = runner(args.journal_dir, args.method)
    np.savez(args.out, coadd=coadd, depth=depth)
    with open(args.out + ".json", "w") as fh:
        json.dump(stats, fh)
    return 0


if __name__ == "__main__":
    sys.exit(worker())

# ===== the tests ================================================================
import hashlib  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

import repro_torch.core as rtc  # noqa: E402
from repro_torch.core.durable import BrickSpill, DiskJournal, JournalStore  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


# ===== fixtures and helpers ==================================================

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def survey():
    return build_survey()


@pytest.fixture(scope="module")
def ref_survey():
    import repro.core as rc
    return rc.make_survey(rc.SurveyConfig(**SURVEY_KW))


QUERY = build_query()
_REFS = {}


def _reference(survey, method):
    """The uninterrupted in-process run (no journal dir): the parity oracle.
    CPU execution is deterministic across processes, so the subprocess
    drills compare against it bitwise."""
    if method not in _REFS:
        _REFS[method] = build_engine(survey).run(QUERY, method)
    return _REFS[method]


def _as_reference(port, ref):
    np.testing.assert_array_equal(port.depth, np.asarray(ref.depth))
    np.testing.assert_allclose(port.coadd, np.asarray(ref.coadd), atol=ATOL, rtol=RTOL)


def _run_worker(args, expect_kill=False, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                          cwd=str(REPO), env=env, capture_output=True, text=True,
                          timeout=timeout)
    if expect_kill:
        assert proc.returncode == -signal.SIGKILL, (
            f"worker exited {proc.returncode}, expected SIGKILL\n{proc.stderr}")
    else:
        assert proc.returncode == 0, proc.stderr
    return proc


def _load_out(out):
    with np.load(out) as z:
        coadd, depth = z["coadd"], z["depth"]
    with open(str(out) + ".json") as fh:
        stats = json.load(fh)
    return coadd, depth, stats


# ===== DiskJournal / JournalStore units =====================================

def _parts(seed, n=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(3, 3)).astype(np.float32) for _ in range(n))


def _fill(root, n=3):
    j = DiskJournal(root)
    keys = [(i, i + 1, 2, 4) for i in range(n)]
    for i, k in enumerate(keys):
        j[k] = _parts(i)
    j.close()
    return keys


def test_disk_journal_roundtrip(tmp_path):
    from repro.core.durable import DiskJournal as RefDiskJournal
    keys = _fill(tmp_path, n=3)
    j = DiskJournal(tmp_path)
    assert len(j) == 3 and j.dropped_records == 0
    for i, k in enumerate(keys):
        assert k in j
        for a, b in zip(j[k], _parts(i)):
            np.testing.assert_array_equal(a, b)
    assert (9, 9, 9, 9) not in j
    j.close()
    # The reference reads the port's journal, record for record.
    ref = RefDiskJournal(tmp_path)
    assert sorted(ref.keys()) == keys and ref.dropped_records == 0
    for i, k in enumerate(keys):
        for a, b in zip(ref[k], _parts(i)):
            np.testing.assert_array_equal(a, b)
    ref.close()


def test_disk_journal_truncated_tail_segment(tmp_path):
    """A torn final payload write replays the valid prefix, never crashes."""
    keys = _fill(tmp_path, n=3)
    seg = tmp_path / DiskJournal.SEGMENT
    seg.write_bytes(seg.read_bytes()[:-5])
    j = DiskJournal(tmp_path)
    assert sorted(j.keys()) == keys[:2]
    assert j.dropped_records == 1
    # The tail was truncated away: appends go to a consistent offset and a
    # re-replay sees the new record.
    j[(7, 8, 2, 4)] = _parts(7)
    j.close()
    j2 = DiskJournal(tmp_path)
    assert sorted(j2.keys()) == sorted(keys[:2] + [(7, 8, 2, 4)])
    assert j2.dropped_records == 0
    j2.close()


def test_disk_journal_truncated_manifest_line(tmp_path):
    keys = _fill(tmp_path, n=3)
    man = tmp_path / DiskJournal.MANIFEST
    raw = man.read_bytes()
    man.write_bytes(raw[: len(raw) - 10])  # tear the last jsonl line
    j = DiskJournal(tmp_path)
    assert sorted(j.keys()) == keys[:2]
    j.close()


def test_disk_journal_bitflip_payload(tmp_path):
    """A flipped byte in record 1's payload drops it AND its suffix: replay
    is a valid *prefix*, never a subset with holes."""
    keys = _fill(tmp_path, n=3)
    man = tmp_path / DiskJournal.MANIFEST
    off = json.loads(man.read_bytes().splitlines()[1])["off"]
    seg = tmp_path / DiskJournal.SEGMENT
    raw = bytearray(seg.read_bytes())
    raw[off + 12] ^= 0xFF
    seg.write_bytes(bytes(raw))
    j = DiskJournal(tmp_path)
    assert sorted(j.keys()) == keys[:1]
    assert j.dropped_records == 2
    j.close()


def test_disk_journal_manifest_payload_mismatch(tmp_path):
    """A manifest digest that no longer matches its payload is dropped."""
    keys = _fill(tmp_path, n=3)
    man = tmp_path / DiskJournal.MANIFEST
    lines = man.read_bytes().splitlines(keepends=True)
    rec = json.loads(lines[-1])
    rec["sha"] = "0" * 64
    lines[-1] = (json.dumps(rec) + "\n").encode()
    man.write_bytes(b"".join(lines))
    j = DiskJournal(tmp_path)
    assert sorted(j.keys()) == keys[:2]
    assert j.dropped_records == 1
    j.close()


def test_journal_store_open_remove_jobs(tmp_path):
    store = JournalStore(tmp_path)
    j = store.open("job-abc")
    j[(0, 1, 1, 2)] = _parts(0)
    j.close()
    assert store.exists("job-abc")
    assert store.jobs() == ["job-abc"[:32]]
    assert store.remove("job-abc")
    assert store.jobs() == [] and not store.exists("job-abc")
    assert not store.remove("job-abc")  # idempotent
    store.drain_tombs()  # deletion is async; wait for the reaper
    assert not list(Path(tmp_path).glob("*.gc.*"))  # tombs reaped


def test_journal_store_sweeps_stale_orphans(tmp_path):
    store = JournalStore(tmp_path, max_age_s=3600.0)
    store.open("job-old").close()
    store.open("job-new").close()
    old_dir = tmp_path / "job-old"
    past = time.time() - 7200.0
    os.utime(old_dir, (past, past))
    store2 = JournalStore(tmp_path, max_age_s=3600.0)
    assert store2.swept == 1
    assert store2.jobs() == ["job-new"]
    assert not old_dir.exists()


# ===== BrickSpill units =====================================================

def _brick_payload(seed=3):
    rng = np.random.default_rng(seed)
    coadd = rng.normal(size=(8, 8)).astype(np.float32)
    depth = rng.integers(0, 5, size=(8, 8)).astype(np.float32)
    meta = {"partial": False, "uncovered_packs": [], "files_considered": 7,
            "files_contributing": 5}
    return coadd, depth, meta


def test_brick_spill_roundtrip(tmp_path):
    from repro.core.durable import BrickSpill as RefBrickSpill
    spill = BrickSpill(tmp_path)
    key = ("brick", "r", 0, 1, ("psf", 1.25))
    coadd, depth, meta = _brick_payload()
    spill.save(key, coadd, depth, meta)
    assert spill.contains(key)
    got = spill.load(key)
    assert got is not None
    np.testing.assert_array_equal(got[0], coadd)
    np.testing.assert_array_equal(got[1], depth)
    assert got[2] == meta
    # The reference finds and verifies the port's file under the same key.
    ref = RefBrickSpill(tmp_path).load(key)
    assert ref is not None and ref[2] == meta
    np.testing.assert_array_equal(ref[0], coadd)
    spill.delete(key)
    assert spill.load(key) is None and spill.corrupt_drops == 0


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "garbage"])
def test_brick_spill_corruption_is_a_miss(tmp_path, damage):
    spill = BrickSpill(tmp_path)
    key = ("brick", "r", 2, 2, ())
    spill.save(key, *_brick_payload())
    path = spill._path(key)
    raw = bytearray(path.read_bytes())
    if damage == "bitflip":
        raw[len(raw) // 2] ^= 0xFF
    elif damage == "truncate":
        raw = raw[: len(raw) // 2]
    else:
        raw = bytearray(b"not an npz at all")
    path.write_bytes(bytes(raw))
    assert spill.load(key) is None       # bad digest -> miss, not a crash
    assert spill.corrupt_drops == 1
    assert not path.exists()             # the corpse is reaped
    assert not spill.contains(key)


# ===== in-process crash + corruption recovery ===============================

def _killed_durable_engine(survey, jd, method="sql_structured"):
    """Run QUERY under a kill-after-1-window injector with a disk journal;
    return the surviving on-disk job directory."""
    inj = rtc.ChaosInjector(rtc.FaultSchedule(kill_after_windows=1))
    eng = build_engine(survey, journal_dir=str(jd), fault_injector=inj)
    with pytest.raises(rtc.QueryKilled):
        eng.run(QUERY, method)
    jobs = eng.journal_store.jobs()
    assert len(jobs) == 1
    return jd / "windows" / jobs[0]


def test_fresh_engine_resumes_disk_journal_bitwise(survey, ref_survey, tmp_path):
    import repro.core as rc
    method = "sql_structured"
    ref = _reference(survey, method)
    _killed_durable_engine(survey, tmp_path / "port", method)
    eng2 = build_engine(survey, journal_dir=str(tmp_path / "port"))
    r = eng2.run(QUERY, method)
    assert r.stats.resumed_windows == 1
    assert r.stats.dispatches == r.stats.windows - 1
    np.testing.assert_array_equal(r.coadd, ref.coadd)
    np.testing.assert_array_equal(r.depth, ref.depth)
    assert eng2.journal_store.jobs() == []  # clean exit GC'd the job
    # The reference's drill on the same windows resumes the same count.
    inj = rc.ChaosInjector(rc.FaultSchedule(kill_after_windows=1))
    killed = build_ref_engine(ref_survey, journal_dir=str(tmp_path / "ref"), fault_injector=inj)
    with pytest.raises(rc.QueryKilled):
        killed.run(rc.CoaddQuery(**QUERY_KW), method)
    want = build_ref_engine(ref_survey, journal_dir=str(tmp_path / "ref")).run(
        rc.CoaddQuery(**QUERY_KW), method)
    assert (r.stats.resumed_windows, r.stats.dispatches, r.stats.windows) == (
        want.stats.resumed_windows, want.stats.dispatches, want.stats.windows)
    _as_reference(r, want)


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "sha"])
def test_corrupted_journal_degrades_to_reexecution(survey, tmp_path, damage):
    """Corruption under the journal re-dispatches the lost windows: the
    answer stays bitwise; only the resume accounting degrades."""
    method = "sql_structured"
    ref = _reference(survey, method)
    job_dir = _killed_durable_engine(survey, tmp_path, method)
    seg = job_dir / DiskJournal.SEGMENT
    man = job_dir / DiskJournal.MANIFEST
    if damage == "truncate":
        seg.write_bytes(seg.read_bytes()[:-3])
    elif damage == "bitflip":
        raw = bytearray(seg.read_bytes())
        raw[len(raw) // 2] ^= 0x10
        seg.write_bytes(bytes(raw))
    else:
        rec = json.loads(man.read_bytes().splitlines()[0])
        rec["sha"] = "f" * 64
        man.write_bytes((json.dumps(rec) + "\n").encode())
    eng2 = build_engine(survey, journal_dir=str(tmp_path))
    r = eng2.run(QUERY, method)
    assert r.stats.resumed_windows == 0      # the one journaled window died
    assert r.stats.dispatches == r.stats.windows
    np.testing.assert_array_equal(r.coadd, ref.coadd)
    np.testing.assert_array_equal(r.depth, ref.depth)
    assert eng2.journal_store.jobs() == []


def test_durable_clean_run_is_bitwise_and_leaves_nothing(survey, ref_survey, tmp_path):
    import repro.core as rc
    method = "raw_fits_prefiltered"
    ref = _reference(survey, method)
    eng = build_engine(survey, journal_dir=str(tmp_path))
    r = eng.run(QUERY, method)
    np.testing.assert_array_equal(r.coadd, ref.coadd)
    np.testing.assert_array_equal(r.depth, ref.depth)
    assert eng.journal_store.jobs() == []
    assert not list((tmp_path / "windows").glob("*.tmp.*"))
    _as_reference(r, build_ref_engine(ref_survey).run(rc.CoaddQuery(**QUERY_KW), method))


def test_engine_init_sweeps_stale_window_journals(survey, tmp_path):
    eng = build_engine(survey, journal_dir=str(tmp_path))
    eng.journal_store.open("orphan-job").close()
    orphan = tmp_path / "windows" / "orphan-job"
    past = time.time() - 8 * 86400.0
    os.utime(orphan, (past, past))
    eng2 = build_engine(survey, journal_dir=str(tmp_path))
    assert eng2.journal_store.swept == 1
    assert not orphan.exists()


# ===== persistent brick store ===============================================

def test_brick_store_persists_across_engines(survey, ref_survey, tmp_path):
    import repro.core as rc
    # Single-pack chunks: the accumulation grouping of per-brick jobs matches
    # the fresh window scan, so parity with `run_window` is bitwise.
    eng = build_engine(survey, journal_dir=str(tmp_path), chunk_packs=1)
    rep = eng.materialize_bricks(bands=("r",))
    n = len(rep.tasks)
    assert rep.completed == n and n > 0
    wq = eng.brick_grid.window_query(0, 2, 0, 2, "r")
    served = eng.run(wq, "sql_structured", use_bricks=True)
    baseline = eng.run_window(wq, "sql_structured")

    eng2 = build_engine(survey, journal_dir=str(tmp_path), chunk_packs=1)
    rep2 = eng2.materialize_bricks(bands=("r",))
    assert rep2.skipped == n and rep2.completed == 0   # all served from disk
    assert eng2.brick_store.disk_loads == n
    served2 = eng2.run(wq, "sql_structured", use_bricks=True)
    assert served2.stats.bricks_hit + served2.stats.bricks_spilled == 4
    np.testing.assert_array_equal(served2.coadd, served.coadd)
    np.testing.assert_array_equal(served2.coadd, baseline.coadd)
    np.testing.assert_array_equal(served2.depth, baseline.depth)
    ref = build_ref_engine(ref_survey, chunk_packs=1)
    _as_reference(served2, ref.run(ref.brick_grid.window_query(0, 2, 0, 2, "r"),
                                   "sql_structured", use_bricks=True))
    assert n == len(ref.brick_grid.bricks(None))


def test_corrupt_spilled_brick_rematerializes(survey, tmp_path):
    eng = build_engine(survey, journal_dir=str(tmp_path), chunk_packs=1)
    rep = eng.materialize_bricks(bands=("r",))
    n = len(rep.tasks)
    files = sorted((tmp_path / "bricks").glob("brick-*.npz"))
    assert len(files) == n
    raw = bytearray(files[0].read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    files[0].write_bytes(bytes(raw))

    eng2 = build_engine(survey, journal_dir=str(tmp_path), chunk_packs=1)
    rep2 = eng2.materialize_bricks(bands=("r",))
    assert rep2.skipped == n - 1 and rep2.completed == 1
    assert eng2.brick_store.spill.corrupt_drops == 1
    wq = eng2.brick_grid.window_query(0, 2, 0, 2, "r")
    served = eng2.run(wq, "sql_structured", use_bricks=True)
    baseline = eng2.run_window(wq, "sql_structured")
    np.testing.assert_array_equal(served.coadd, baseline.coadd)
    np.testing.assert_array_equal(served.depth, baseline.depth)


# ===== SIGKILL process-death drills =========================================

FAST_KILL_METHODS = ("sql_structured", "raw_fits_prefiltered")
SLOW_KILL_METHODS = tuple(m for m in rt.METHODS if m not in FAST_KILL_METHODS)


def _stream_drill(survey, tmp_path, method, crash):
    ref = _reference(survey, method)
    jd, out = tmp_path / "journal", tmp_path / "out.npz"
    base = ["--journal-dir", str(jd), "--out", str(out), "--method", method]
    _run_worker(base + ["--crash", crash], expect_kill=True)
    assert not out.exists()                     # it really died mid-job
    store = JournalStore(jd / "windows")
    assert store.jobs(), "no journal survived the kill"
    _run_worker(base)                           # fresh process, same journal
    coadd, depth, stats = _load_out(out)
    assert stats["resumed_windows"] >= 1
    assert stats["dispatches"] == stats["windows"] - stats["resumed_windows"]
    assert stats["jobs_left"] == []
    np.testing.assert_array_equal(coadd, ref.coadd)
    np.testing.assert_array_equal(depth, ref.depth)


@pytest.mark.parametrize("method", FAST_KILL_METHODS)
def test_sigkill_streaming_resumes_bitwise(survey, tmp_path, method):
    """SIGKILL after the first window commits; a fresh process replays it."""
    _stream_drill(survey, tmp_path, method, "manifest_done:0")


@pytest.mark.slow
@pytest.mark.parametrize("method", SLOW_KILL_METHODS)
def test_sigkill_streaming_resumes_bitwise_slow(survey, tmp_path, method):
    _stream_drill(survey, tmp_path, method, "manifest_done:0")


def test_sigkill_mid_segment_write(survey, tmp_path):
    """Death *inside* the second window's payload write: the torn tail is
    truncated on replay and only window 0 resumes from the journal."""
    _stream_drill(survey, tmp_path, "sql_structured", "payload_mid:1")


def test_sigkill_after_payload_before_manifest(survey, tmp_path):
    """Death between payload append and manifest append: the record was
    never committed, so it re-executes (atomicity of the commit point)."""
    _stream_drill(survey, tmp_path, "sql_structured", "payload_done:1")


def _bricks_clean(tmp_path):
    """The uninterrupted materialization and mosaic, in this process (CPU
    execution is deterministic across processes)."""
    return run_bricks(str(tmp_path / "j2"), "sql_structured")[:2]


def test_sigkill_during_materialize_resumes(survey, tmp_path):
    """SIGKILL mid-materialization: finished bricks skip, the in-flight
    brick resumes from its window journal, the mosaic stays bitwise."""
    jd, out = tmp_path / "journal", tmp_path / "out.npz"
    base = ["--journal-dir", str(jd), "--out", str(out), "--mode", "bricks"]
    _run_worker(base + ["--crash", "brick_done:1"], expect_kill=True)
    spilled = list((jd / "bricks").glob("brick-*.npz"))
    assert len(spilled) >= 1                    # at least one brick durable
    _run_worker(base)
    coadd, depth, stats = _load_out(out)
    assert stats["skipped"] >= 1
    assert stats["skipped"] + stats["completed"] == stats["n_bricks"]
    assert stats["jobs_left"] == []
    ref_coadd, ref_depth = _bricks_clean(tmp_path)
    np.testing.assert_array_equal(coadd, ref_coadd)
    np.testing.assert_array_equal(depth, ref_depth)


@pytest.mark.slow
def test_sigkill_during_materialize_window_journal_resumes(survey, tmp_path):
    """Kill at a *window* commit inside some brick's streaming job: the
    restarted job shows window-journal replay (resumed_windows > 0)."""
    jd, out = tmp_path / "journal", tmp_path / "out.npz"
    base = ["--journal-dir", str(jd), "--out", str(out), "--mode", "bricks"]
    _run_worker(base + ["--crash", "manifest_done:2"], expect_kill=True)
    store = JournalStore(jd / "windows")
    assert store.jobs(), "the in-flight brick left no window journal"
    _run_worker(base)
    coadd, depth, stats = _load_out(out)
    assert stats["resumed_windows"] >= 1
    assert stats["skipped"] + stats["completed"] == stats["n_bricks"]
    ref_coadd, ref_depth = _bricks_clean(tmp_path)
    np.testing.assert_array_equal(coadd, ref_coadd)
    np.testing.assert_array_equal(depth, ref_depth)


# ===== quarantine auto-release ==============================================

def test_residency_reverify_releases_repaired_packs():
    res = rtc.ResidencyManager()

    class HostDS:
        def __init__(self):
            rng = np.random.default_rng(11)
            self.pixels = rng.normal(size=(4, 2, 4, 4)).astype(np.float32)

    ds = HostDS()
    digests = [hashlib.sha256(np.ascontiguousarray(ds.pixels[p]).tobytes()).digest()
               for p in range(4)]
    saved = ds.pixels[1].copy()
    ds.pixels[1, 0, 0, 0] = np.nan      # poisoned
    ds.pixels[2, 0, 0, 0] += 1.0        # finite but not the ingested bytes
    res.quarantine_packs("structured", [1, 2], digests)
    assert res.quarantined_packs("structured") == frozenset({1, 2})
    assert res.reverify_quarantined("structured", ds) == []   # nothing healed
    ds.pixels[1] = saved
    assert res.reverify_quarantined("structured", ds) == [1]  # 1 healed, 2 not
    assert res.quarantined_packs("structured") == frozenset({2})
    assert res.quarantine_released == 1
    ds.pixels[2, 0, 0, 0] -= 1.0
    assert res.reverify_quarantined("structured", ds) == [2]
    assert res.quarantine_released == 2
    assert res.quarantined == {}        # empty layouts leave the registry


def test_reverify_without_reference_digest_uses_finiteness():
    res = rtc.ResidencyManager()

    class HostDS:
        pixels = None

    ds = HostDS()
    ds.pixels = np.ones((2, 1, 2, 2), np.float32)
    ds.pixels[0, 0, 0, 0] = np.inf
    res.quarantine_packs("structured", [0, 1])   # no digests recorded
    assert res.reverify_quarantined("structured", ds) == [1]
    ds.pixels[0, 0, 0, 0] = 0.0
    assert res.reverify_quarantined("structured", ds) == [0]


def test_engine_quarantine_release_restores_full_coverage(survey, ref_survey):
    """End to end: real host corruption quarantines persistently across
    queries; repairing the bytes and `reverify_quarantined` release the
    pack and the next query completes full-coverage, bitwise with clean;
    the same drill on the reference reports the same coverage."""
    import repro.core as rc
    method = "sql_structured"
    ref = _reference(survey, method)
    engines = (build_engine(survey, on_fault="quarantine", verify_digests=True),
               build_ref_engine(ref_survey, on_fault="quarantine", verify_digests=True))
    runs = []
    for eng, q in zip(engines, (QUERY, rc.CoaddQuery(**QUERY_KW))):
        plan = eng.plan(q, method)
        exec_ds, _ = eng.exec_dataset(plan.layout)
        exec_ds.pack_digests()              # prime the reference digests
        gate = eng._exec_gate(plan)
        bad = int(np.nonzero(np.asarray(gate).any(axis=1))[0][0])
        saved = exec_ds.pixels[bad].copy()
        exec_ds.pixels[bad, ...] = np.nan   # persistent host corruption
        try:
            r1 = eng.run(q, method)
            assert r1.stats.partial and bad in r1.stats.uncovered_packs
            assert bad in eng.residency.quarantined_packs(plan.layout)
            r2 = eng.run(q, method)         # persists: pre-gated, still partial
            assert r2.stats.partial and r2.stats.quarantined_packs == 0
            assert eng.reverify_quarantined(plan.layout) == []  # still poisoned
        finally:
            exec_ds.pixels[bad] = saved     # repair the host
        assert eng.reverify_quarantined(plan.layout) == [bad]
        assert eng.residency.quarantined_packs(plan.layout) == frozenset()
        r3 = eng.run(q, method)
        assert not r3.stats.partial
        assert r3.stats.requarantine_released == 1
        assert r3.stats.uncovered_packs == ()
        r4 = eng.run(q, method)
        assert r4.stats.requarantine_released == 0  # the counter is one-shot
        runs.append((r1, r3))
    (p1, p3), (w1, w3) = runs
    np.testing.assert_array_equal(p3.coadd, ref.coadd)
    np.testing.assert_array_equal(p3.depth, ref.depth)
    assert (p1.stats.uncovered_packs, p1.stats.retries, p1.stats.quarantined_packs) == (
        w1.stats.uncovered_packs, w1.stats.retries, w1.stats.quarantined_packs)
    _as_reference(p1, w1)
    _as_reference(p3, w3)


# ===== concurrent speculation ===============================================

def _mkwin(k):
    return rtc.ScanWindow(start=k, stop=k + 1, sel=np.array([k]),
                          pack_idx=np.zeros(1, np.int32), n_gated=1, budget=1)


def test_concurrent_backup_does_not_serialize_the_run():
    """A straggler's backup runs on a worker thread, so the main loop
    reaches *later* windows while the backup is still in flight.  The
    backup refuses to finish until a later window's primary dispatch has
    started: a serialized speculation would deadlock (and time out)."""
    later_started = threading.Event()
    saw = {"later_window_ran_during_backup": False}
    windows = [_mkwin(k) for k in range(4)]
    calls = {}

    def acquire(win, drop):
        return None

    def dispatch(ops, win, drop):
        n = calls.get(win.key, 0)
        calls[win.key] = n + 1
        if win.key == windows[2].key:
            later_started.set()
        if win.key == windows[1].key:
            if n == 0:
                time.sleep(0.25)        # the straggling primary
            else:
                # the backup: wait for proof the main loop moved on
                saw["later_window_ran_during_backup"] = later_started.wait(10.0)
        return (np.ones(2, np.float32),)

    tr = rtc.WindowTracker(straggler_factor=3.0, straggler_min_windows=1, backoff_s=1e-4)
    acc, quar = tr.run(windows, acquire, dispatch, {})
    assert quar == []
    assert tr.counters.speculative_windows >= 1
    assert calls[windows[1].key] == 2
    assert saw["later_window_ran_during_backup"], (
        "backup thread blocked the main loop (speculation is serialized)")
    np.testing.assert_array_equal(acc[0], np.full(2, 4.0, np.float32))


def test_serialized_speculation_mode_still_available():
    windows = [_mkwin(k) for k in range(3)]

    def dispatch(ops, win, drop):
        if win.key == windows[1].key:
            time.sleep(0.1)
        return (np.ones(1, np.float32),)

    tr = rtc.WindowTracker(straggler_factor=3.0, straggler_min_windows=1,
                           concurrent_speculation=False)
    acc, _ = tr.run(windows, lambda w, d: None, dispatch, {})
    assert tr.counters.speculative_windows >= 1
    assert tr._backups == []            # nothing ever went to a thread
    np.testing.assert_array_equal(acc[0], np.full(1, 3.0, np.float32))


def test_engine_speculation_concurrent_by_default_bitwise(survey, ref_survey):
    """Straggler speculation under the real engine (slow-window injector):
    concurrent backups keep bitwise parity and digest agreement, as the
    reference's do."""
    import repro.core as rc
    method = "sql_structured"
    eng0 = build_engine(survey, chunk_packs=1)
    plan = eng0.plan(QUERY, method)
    exec_ds, _ = eng0.exec_dataset(plan.layout)
    gate = np.asarray(eng0._exec_gate(plan))
    n_windows = len(eng0._stream_windows(exec_ds, gate.any(axis=1)))
    assert n_windows >= 3
    clean = eng0.run(QUERY, method)
    inj = rtc.ChaosInjector(rtc.FaultSchedule(slow_windows={n_windows - 1: 0.05}))
    eng = build_engine(survey, chunk_packs=1, fault_injector=inj, straggler_factor=3.0)
    r = eng.run(QUERY, method)
    np.testing.assert_array_equal(r.coadd, clean.coadd)
    np.testing.assert_array_equal(r.depth, clean.depth)
    assert r.stats.speculative_windows >= 1
    ref_inj = rc.ChaosInjector(rc.FaultSchedule(slow_windows={n_windows - 1: 0.05}))
    want = build_ref_engine(ref_survey, chunk_packs=1, fault_injector=ref_inj,
                            straggler_factor=3.0).run(rc.CoaddQuery(**QUERY_KW), method)
    assert dict(inj.injected) == dict(ref_inj.injected)
    _as_reference(r, want)
