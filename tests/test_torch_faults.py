"""The streamed path's fault domain in the port (DESIGN.md §8), held against
the JAX package.

Ports every test of ``tests/test_faults.py`` onto ``repro_torch``
(``device="cpu"``; ``use_kernel=True`` on the CPU runs the kernels' plain
versions).  Every chaos drill runs twice: on the port, held bitwise against
the port's own fault-free streamed run, and on the reference under the same
`FaultSchedule`, which the port matches in the injected faults (the
injector's ``injected`` counter), ``retries``, ``resumed_windows``,
``quarantined_packs`` and ``uncovered_packs``, depth exactly and coadd at
the reference's streaming tolerance (atol 5e-2 / rtol 1e-3,
tests/test_streaming.py:129).

Both engines stream the same windows and hold the same chunks: the port's
chunk is half its budget, so each package's budget is (2c + 1) of its own
pack's bytes for chunks of c packs (the reference also sets
``stream_chunk_packs=c``), which leaves room for two chunks of two packs or
three of one.  Then upload ordinals, retries and resumed windows line up
count for count.  The port reads a chunk's NaN/Inf flags just before its
first scan (the reference scans the host copy before the upload), so a
poisoned chunk is uploaded, dropped and uploaded again: its residency
counters differ from the reference's, its retries do not.

The CUDA path runs only on a card: those tests carry the ``gpu`` marker
and skip here (``python3 chip_smoke.py`` drives the drills at full size).
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
import repro_torch.core as rtc
from repro.core.jobtracker import partial_digest as ref_partial_digest
from repro_torch.core.jobtracker import partial_digest

CFG = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
QUERY = dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
QUERY2 = dict(band="g", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
ATOL, RTOL = 5e-2, 1e-3          # the reference's streaming tolerance
ROBUST = ("clipped", "median")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


def _schedule(pkg, upload_fail=(), poison=(), slow=None, kill=None):
    """One `FaultSchedule` in either package; ``poison`` as (pack, mode,
    count) triples."""
    core = rc if pkg is rc else rtc
    return core.FaultSchedule(
        upload_fail_ordinals=tuple(upload_fail),
        poison=tuple(core.PoisonSpec(p, m, c) for p, m, c in poison),
        slow_windows=dict(slow or {}),
        kill_after_windows=kill,
    )


_PACK_BYTES = {}


def _engine(pkg, survey, chunk_packs=2, sched=None, **kw):
    """A streaming engine of either package at (2 chunk_packs + 1) of its
    own pack's bytes, fast backoff -> (engine, injector or None)."""
    core = rc if pkg is rc else rtc
    dev = {} if pkg is rc else {"device": "cpu"}
    if pkg not in _PACK_BYTES:
        probe = pkg.CoaddEngine(survey, pack_capacity=8, **dev)
        _PACK_BYTES[pkg] = probe.exec_dataset("structured")[0].pack_nbytes()
    if pkg is rc:
        kw["stream_chunk_packs"] = chunk_packs
    inj = None if sched is None else core.ChaosInjector(sched)
    eng = pkg.CoaddEngine(survey, pack_capacity=8,
                          device_budget_bytes=(2 * chunk_packs + 1) * _PACK_BYTES[pkg],
                          fault_backoff_s=1e-4, fault_injector=inj, **dev, **kw)
    return eng, inj


def _pair(surveys, chunk_packs=2, sched=None, **kw):
    """(reference engine, reference injector, port engine, port injector)
    under the same schedule, ``sched`` a dict of `_schedule` arguments."""
    ref, ref_inj = _engine(rc, surveys[0], chunk_packs,
                           None if sched is None else _schedule(rc, **sched), **kw)
    port, port_inj = _engine(rt, surveys[1], chunk_packs,
                             None if sched is None else _schedule(rt, **sched), **kw)
    return ref, ref_inj, port, port_inj


_CLEAN = {}


def _clean(surveys, method, chunk_packs=2, reduce="mean"):
    """The port's fault-free streamed run, shared across the matrix."""
    key = (method, chunk_packs, reduce)
    if key not in _CLEAN:
        eng, _ = _engine(rt, surveys[1], chunk_packs)
        _CLEAN[key] = eng.run(rt.CoaddQuery(**QUERY), method, reduce=reduce)
    return _CLEAN[key]


def _query_shape(surveys, method, chunk_packs=2):
    """(gated global packs, n_windows) of the clean query, the same in both
    packages."""
    shapes = []
    for pkg, survey in ((rc, surveys[0]), (rt, surveys[1])):
        eng, _ = _engine(pkg, survey, chunk_packs)
        plan = eng.plan(pkg.CoaddQuery(**QUERY), method)
        gate = np.asarray(eng._exec_gate(plan))
        exec_ds, _ = eng.exec_dataset(plan.layout)
        shapes.append((np.nonzero(gate.any(axis=1))[0],
                       len(eng._stream_windows(exec_ds, gate.any(axis=1)))))
    (ref_packs, ref_n), (packs, n) = shapes
    assert np.array_equal(packs, ref_packs) and n == ref_n
    return packs, n


def _bitwise(got, want):
    np.testing.assert_array_equal(got.coadd, want.coadd)
    np.testing.assert_array_equal(got.depth, want.depth)


def _as_reference(port, ref, port_inj=None, ref_inj=None):
    """The port's drill against the reference's under the same schedule."""
    if port_inj is not None:
        assert dict(port_inj.injected) == dict(ref_inj.injected)
    g, w = port.stats, ref.stats
    assert (g.retries, g.resumed_windows, g.quarantined_packs) == (
        w.retries, w.resumed_windows, w.quarantined_packs)
    assert (g.partial, g.uncovered_packs) == (w.partial, w.uncovered_packs)
    np.testing.assert_array_equal(port.depth, np.asarray(ref.depth))
    np.testing.assert_allclose(port.coadd, np.asarray(ref.coadd), atol=ATOL, rtol=RTOL)


def _run_both(surveys, method, chunk_packs=2, sched=None, reduce="mean", **kw):
    """One drill on both packages -> (port result, port injector)."""
    ref, ref_inj, port, port_inj = _pair(surveys, chunk_packs, sched, **kw)
    want = ref.run(rc.CoaddQuery(**QUERY), method, reduce=reduce)
    got = port.run(rt.CoaddQuery(**QUERY), method, reduce=reduce)
    _as_reference(got, want, port_inj, ref_inj)
    return got, port_inj


# ----- the 6-method chaos matrix -------------------------------------------

@pytest.mark.parametrize("method", rt.METHODS)
def test_upload_failure_retries_to_bitwise_parity(surveys, method):
    r, inj = _run_both(surveys, method, sched=dict(upload_fail=(0,)))
    assert inj.injected["upload_fail"] == 1
    assert r.stats.retries >= 1
    assert not r.stats.partial
    _bitwise(r, _clean(surveys, method))


@pytest.mark.parametrize("method", rt.METHODS)
def test_poisoned_chunk_retries_to_bitwise_parity(surveys, method):
    packs, _ = _query_shape(surveys, method)
    r, inj = _run_both(surveys, method, sched=dict(poison=((int(packs[0]), "nan", 1),)))
    assert inj.injected["poison"] >= 1
    assert r.stats.retries >= 1
    _bitwise(r, _clean(surveys, method))


@pytest.mark.parametrize("method", rt.METHODS)
def test_straggler_speculation_bitwise_parity(surveys, method):
    # Single-pack chunks force enough windows for a duration median.
    _, n_windows = _query_shape(surveys, method, chunk_packs=1)
    assert n_windows >= 3
    r, inj = _run_both(surveys, method, chunk_packs=1, sched=dict(slow={n_windows - 1: 0.05}),
                       straggler_factor=3.0)
    assert inj.injected["slow"] == 1
    assert r.stats.speculative_windows >= 1
    _bitwise(r, _clean(surveys, method, chunk_packs=1))


@pytest.mark.parametrize("method", rt.METHODS)
def test_kill_and_resume_replays_only_missing_windows(surveys, method):
    _, n_windows = _query_shape(surveys, method)
    assert n_windows >= 2
    ref, ref_inj, port, port_inj = _pair(surveys, sched=dict(kill=1))
    for eng, pkg in ((ref, rc), (port, rt)):
        with pytest.raises(rc.QueryKilled if pkg is rc else rtc.QueryKilled):
            eng.run(pkg.CoaddQuery(**QUERY), method)
        assert len(eng._journals) == 1  # the killed query's journal survives
    want = ref.run(rc.CoaddQuery(**QUERY), method)
    r = port.run(rt.CoaddQuery(**QUERY), method)   # the injector fired once
    # Exactly the windows finished before the kill replay from the journal.
    assert r.stats.resumed_windows == 1
    assert r.stats.dispatches == n_windows - 1
    assert len(port._journals) == 0  # completion retires the journal
    _as_reference(r, want, port_inj, ref_inj)
    _bitwise(r, _clean(surveys, method))


# ----- quarantine accounting -----------------------------------------------

def test_quarantine_completes_partial_with_correct_depth(surveys):
    method = "sql_structured"
    packs, _ = _query_shape(surveys, method)
    bad = int(packs[0])
    r, _ = _run_both(surveys, method, sched=dict(poison=((bad, "nan", None),)),
                     on_fault="quarantine")
    assert r.stats.partial
    assert r.stats.uncovered_packs == (bad,)
    assert r.stats.quarantined_packs == 1
    assert np.isfinite(r.coadd).all() and np.isfinite(r.depth).all()
    # Ground truth: the same query with the quarantined pack's slots gated
    # off at plan time (sql_structured plans on the execution layout).
    eng, _ = _engine(rt, surveys[1])
    plan = eng.plan(rt.CoaddQuery(**QUERY), method)
    plan.gate[bad] = False
    clean = eng.execute(plan)
    np.testing.assert_allclose(r.coadd, clean.coadd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r.depth, clean.depth)
    assert r.stats.files_contributing == clean.stats.files_contributing
    assert r.stats.files_considered == clean.stats.files_considered


def test_persistent_poison_exhausts_retry_policy(surveys):
    packs, _ = _query_shape(surveys, "sql_structured")
    sched = dict(poison=((int(packs[0]), "nan", None),))
    ref, _, port, _ = _pair(surveys, sched=sched, on_fault="retry")
    with pytest.raises(rc.PoisonedChunkError):
        ref.run(rc.CoaddQuery(**QUERY), "sql_structured")
    with pytest.raises(rtc.PoisonedChunkError):
        port.run(rt.CoaddQuery(**QUERY), "sql_structured")


def test_raise_policy_aborts_on_first_fault(surveys):
    ref, _, port, _ = _pair(surveys, sched=dict(upload_fail=(0,)), on_fault="raise")
    with pytest.raises(rc.TransientFault):
        ref.run(rc.CoaddQuery(**QUERY), "sql_structured")
    with pytest.raises(rtc.TransientFault):
        port.run(rt.CoaddQuery(**QUERY), "sql_structured")


def test_digest_verification_catches_finite_corruption(surveys):
    """mode="flip" corruption is finite: invisible to the NaN/Inf flags,
    caught only by the per-pack digest against the host layout."""
    method = "sql_structured"
    packs, _ = _query_shape(surveys, method)
    sched = dict(poison=((int(packs[0]), "flip", 1),))
    # Without digests the corruption sails through (and corrupts the coadd).
    blind, _ = _run_both(surveys, method, sched=sched)
    assert blind.stats.retries == 0
    assert not np.array_equal(blind.coadd, _clean(surveys, method).coadd)
    # With digests it's detected, retried, and healed to bitwise parity.
    r, _ = _run_both(surveys, method, sched=sched, verify_digests=True)
    assert r.stats.retries >= 1
    _bitwise(r, _clean(surveys, method))


# ----- batched streaming under faults --------------------------------------

def test_batch_streaming_heals_upload_failure(surveys):
    clean_eng, _ = _engine(rt, surveys[1])
    qs = [rt.CoaddQuery(**QUERY), rt.CoaddQuery(**QUERY2)]
    clean = clean_eng.run_batch(qs, "sql_structured")
    ref, ref_inj, port, port_inj = _pair(surveys, sched=dict(upload_fail=(0,)))
    want = ref.run_batch([rc.CoaddQuery(**QUERY), rc.CoaddQuery(**QUERY2)], "sql_structured")
    faulted = port.run_batch(qs, "sql_structured")
    assert faulted[0].stats.retries >= 1
    for c, f, w in zip(clean, faulted, want):
        _bitwise(f, c)
        _as_reference(f, w)
    assert dict(port_inj.injected) == dict(ref_inj.injected)


# ----- robust multi-pass fault domain (DESIGN.md §11) -----------------------

@pytest.mark.parametrize("red", ROBUST)
def test_robust_midpass_kill_replays_partial_journal_bitwise(surveys, red):
    """A kill inside pass 1 leaves a partial pass-1 journal; the resume
    replays exactly the finished window and reproduces the uninterrupted
    robust stack bitwise."""
    _, n_windows = _query_shape(surveys, "sql_structured")
    assert n_windows >= 2
    ref, ref_inj, port, port_inj = _pair(surveys, sched=dict(kill=1))
    with pytest.raises(rc.QueryKilled):
        ref.run(rc.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    with pytest.raises(rtc.QueryKilled):
        port.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    assert len(port._journals) == 1      # the killed pass's journal survives
    want = ref.run(rc.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    r = port.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    assert r.stats.resumed_windows == 1  # only the finished window replays
    assert r.stats.reduce_passes == (3 if red == "median" else 2)
    assert len(port._journals) == 0      # completion retires every pass journal
    _as_reference(r, want, port_inj, ref_inj)
    _bitwise(r, _clean(surveys, "sql_structured", reduce=red))


@pytest.mark.parametrize("red", ROBUST)
def test_robust_seam_kill_resumes_without_rerunning_pass1(surveys, red):
    """A kill at the pass-1/pass-2 seam (every pass-1 window journaled, no
    later pass started) resumes by replaying ALL of pass 1 from the journal
    and still matches bitwise."""
    _, n_windows = _query_shape(surveys, "sql_structured")
    ref, ref_inj, port, port_inj = _pair(surveys, sched=dict(kill=n_windows))
    with pytest.raises(rc.QueryKilled):
        ref.run(rc.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    with pytest.raises(rtc.QueryKilled):
        port.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    assert len(port._journals) == 1
    want = ref.run(rc.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    r = port.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce=red)
    assert r.stats.resumed_windows == n_windows  # pass 1 replayed, not rerun
    _as_reference(r, want, port_inj, ref_inj)
    _bitwise(r, _clean(surveys, "sql_structured", reduce=red))


@pytest.mark.parametrize("red", ROBUST)
def test_robust_upload_failure_retries_to_bitwise_parity(surveys, red):
    r, inj = _run_both(surveys, "sql_structured", sched=dict(upload_fail=(0,)), reduce=red)
    assert inj.injected["upload_fail"] == 1
    assert r.stats.retries >= 1
    _bitwise(r, _clean(surveys, "sql_structured", reduce=red))


@pytest.mark.parametrize("red", ROBUST)
def test_robust_quarantine_excludes_pack_from_every_pass(surveys, red):
    """A persistently poisoned pack quarantined during pass 1 stays excluded
    through the clip pass: the answer equals the clean robust run with that
    pack gated off at plan time."""
    method = "sql_structured"
    packs, _ = _query_shape(surveys, method)
    bad = int(packs[0])
    r, _ = _run_both(surveys, method, sched=dict(poison=((bad, "nan", None),)),
                     on_fault="quarantine", reduce=red)
    assert r.stats.partial
    assert r.stats.uncovered_packs == (bad,)
    assert r.stats.quarantined_packs >= 1
    assert np.isfinite(r.coadd).all() and np.isfinite(r.depth).all()
    eng, _ = _engine(rt, surveys[1])
    plan = eng.plan(rt.CoaddQuery(**QUERY), method, reduce=red)
    plan.gate[bad] = False
    clean = eng.execute(plan)
    np.testing.assert_array_equal(r.depth, clean.depth)
    np.testing.assert_allclose(r.coadd, clean.coadd, rtol=1e-5, atol=1e-5)


# ----- the seeded acceptance drill -----------------------------------------

def test_seeded_chaos_drill_all_faults_at_once(surveys):
    """A seeded schedule lands >=1 upload failure, >=1 poisoned chunk and
    >=1 straggler in ONE query; retry and speculation reproduce the
    fault-free coadd bitwise.  The seed draws the same schedule in both
    packages."""
    method = "sql_structured"
    packs, n_windows = _query_shape(surveys, method, chunk_packs=1)
    args = dict(seed=82, n_uploads=n_windows, n_windows=n_windows, gated_packs=packs,
                upload_fails=1, poisons=1, stragglers=1, slow_s=0.05)
    want_sched = rc.FaultSchedule.seeded(**args)
    sched = rtc.FaultSchedule.seeded(**args)
    assert sched.upload_fail_ordinals == want_sched.upload_fail_ordinals
    assert [(p.pack, p.mode, p.count) for p in sched.poison] == [
        (p.pack, p.mode, p.count) for p in want_sched.poison]
    assert sched.slow_windows == want_sched.slow_windows
    ref, ref_inj = _engine(rc, surveys[0], 1, want_sched, straggler_factor=3.0)
    port, inj = _engine(rt, surveys[1], 1, sched, straggler_factor=3.0)
    want = ref.run(rc.CoaddQuery(**QUERY), method)
    r = port.run(rt.CoaddQuery(**QUERY), method)
    assert inj.injected["upload_fail"] >= 1
    assert inj.injected["poison"] >= 1
    assert inj.injected["slow"] >= 1
    assert r.stats.retries >= 2  # the upload failure and the poison
    _as_reference(r, want, inj, ref_inj)
    _bitwise(r, _clean(surveys, method, chunk_packs=1))


def test_seeded_schedule_is_deterministic():
    packs = np.arange(12)
    a = rtc.FaultSchedule.seeded(seed=7, n_uploads=6, n_windows=6, gated_packs=packs)
    b = rtc.FaultSchedule.seeded(seed=7, n_uploads=6, n_windows=6, gated_packs=packs)
    assert a == b
    c = rtc.FaultSchedule.seeded(seed=8, n_uploads=6, n_windows=6, gated_packs=packs)
    assert a != c


# ----- unit-level tracker/harness behavior ---------------------------------

class _FakeWin:
    def __init__(self, i):
        self.key = (i, i + 1, 1, 1)


def test_window_tracker_backoff_is_capped_exponential():
    sleeps = []
    tr = rtc.WindowTracker(backoff_s=0.1, backoff_cap_s=0.35, max_attempts=5,
                           sleep=sleeps.append)
    calls = [0]

    def acquire(win, quarantined):
        calls[0] += 1
        if calls[0] < 5:
            raise rtc.TransientFault("flaky")
        return "ops"

    out, quar = tr.run([_FakeWin(0)], acquire, lambda ops, win, q: (np.ones(2),), {})
    assert sleeps == [0.1, 0.2, 0.35, 0.35]  # doubling, then capped
    assert tr.counters.retries == 4
    assert quar == []


def test_window_tracker_speculation_flags_nondeterminism():
    tr = rtc.WindowTracker(straggler_factor=1.5, straggler_min_windows=1)
    rng = np.random.default_rng(0)

    def dispatch(ops, win, quarantined):
        import time as _t
        if win.key[0] == 2:
            _t.sleep(0.05)  # the straggler: its backup re-rolls the dice
        return (rng.normal(size=4),)  # nondeterministic executor

    wins = [_FakeWin(i) for i in range(3)]
    with pytest.raises(rtc.DeterminismError):
        tr.run(wins, lambda w, q: "ops", dispatch, {})
    assert tr.counters.speculative_windows == 1


def test_window_tracker_fatal_errors_escape_immediately():
    tr = rtc.WindowTracker(max_attempts=5)
    attempts = [0]

    def acquire(win, quarantined):
        attempts[0] += 1
        raise ValueError("fatal config error")

    with pytest.raises(ValueError):
        tr.run([_FakeWin(0)], acquire, lambda o, w, q: (np.zeros(1),), {})
    assert attempts[0] == 1  # no retry net around fatal errors
    assert tr.counters.retries == 0


def test_window_tracker_stages_before_the_in_place_sums():
    """The port's hooks: a window is staged for the journal right after its
    dispatch, before the in-place ``accumulate`` adds the next partial into
    the first one, so the journal holds each window's own partial; a rerun
    loads it and sums to the same bits.  The next chunk is acquired before
    a window is dispatched (the double buffer)."""
    order = []

    def acquire(win, drop):
        order.append(("acquire", win.key[0]))
        return win.key[0]

    def dispatch(ops, win, drop):
        order.append(("dispatch", ops))
        return (torch.full((2,), float(ops + 1)),)

    stage = lambda part: tuple(t.clone() for t in part)             # noqa: E731
    load = lambda value: tuple(t.clone() for t in value)            # noqa: E731
    add = lambda acc, part: tuple(a.add_(b) for a, b in zip(acc, part))  # noqa: E731
    journal = {}
    wins = [_FakeWin(i) for i in range(3)]
    acc, _ = rtc.WindowTracker().run(wins, acquire, dispatch, journal, stage, load, add)
    assert acc[0].tolist() == [6.0, 6.0]
    assert [journal[w.key][0][0].item() for w in wins] == [1.0, 2.0, 3.0]
    assert order[:3] == [("acquire", 0), ("acquire", 1), ("dispatch", 0)]
    tr = rtc.WindowTracker()
    again, _ = tr.run(wins, acquire, dispatch, journal, stage, load, add)
    assert tr.counters.resumed_windows == 3 and torch.equal(again[0], acc[0])


def test_classification_taxonomy():
    cases = ((lambda m: m.TransientFault("x"), "transient"),
             (lambda m: ConnectionError("x"), "transient"),
             (lambda m: OSError("x"), "transient"),
             (lambda m: RuntimeError("device"), "transient"),
             (lambda m: m.PoisonedChunkError([3]), "transient"),
             (lambda m: m.DeterminismError("x"), "fatal"),
             (lambda m: m.QueryKilled("x"), "fatal"),
             (lambda m: ValueError("x"), "fatal"),
             (lambda m: KeyError("x"), "fatal"))
    for make, kind in cases:
        assert rtc.classify(make(rtc)) == kind == rc.classify(make(rc))


def test_partial_digest_distinguishes_content():
    a = (np.ones((4, 4)), np.zeros(3))
    b = (np.ones((4, 4)), np.zeros(3))
    c = (np.ones((4, 4)) * 2, np.zeros(3))
    assert partial_digest(a) == partial_digest(b)
    assert partial_digest(a) != partial_digest(c)
    # Tensors hash the same bytes as the reference hashes for equal arrays.
    t = (torch.ones(4, 4, dtype=torch.float32), torch.zeros(3, dtype=torch.float32))
    n = (np.ones((4, 4), np.float32), np.zeros(3, np.float32))
    assert partial_digest(t) == ref_partial_digest(n) == partial_digest(n)


def test_residency_failed_build_leaves_manager_consistent():
    mgr = rtc.ResidencyManager(budget_bytes=100)
    mgr.acquire(("a",), 40, lambda: "A")
    with pytest.raises(rtc.TransientFault):
        mgr.acquire(("b",), 40, lambda: (_ for _ in ()).throw(rtc.TransientFault("upload lost")))
    assert mgr.failed_builds == 1
    assert mgr.n_resident == 1          # no phantom entry
    assert mgr.uploads == 1             # failed build never counted
    # Retry succeeds and the manager looks like the failure never happened.
    assert mgr.acquire(("b",), 40, lambda: "B") == "B"
    assert mgr.n_resident == 2 and mgr.uploads == 2


def test_residency_fault_hook_failure_counts_and_propagates():
    mgr = rtc.ResidencyManager(budget_bytes=100)
    fired = []

    def hook(key):
        fired.append(key)
        raise rtc.TransientFault("injected")

    mgr.fault_hook = hook
    with pytest.raises(rtc.TransientFault):
        mgr.acquire(("k",), 10, lambda: "payload")
    assert fired == [("k",)]
    assert mgr.failed_builds == 1 and mgr.n_resident == 0
    mgr.fault_hook = None
    assert mgr.acquire(("k",), 10, lambda: "payload") == "payload"


def test_scan_window_key_is_schedule_unique():
    wins = rtc.window_schedule(np.array([0, 1, 5, 9, 10, 11]), 12, 4)
    keys = [w.key for w in wins]
    assert len(set(keys)) == len(keys)
    want = rc.window_schedule(np.array([0, 1, 5, 9, 10, 11]), 12, 4)
    assert keys == [w.key for w in want]


# ----- the port's clean path under the tracker -------------------------------

@pytest.mark.parametrize("red", ("mean", "median"))
def test_tracked_clean_query_is_the_bare_loop(surveys, monkeypatch, red):
    """A clean query under ``on_fault="retry"`` is bitwise the same query on
    the bare loop (``"raise"``), with the same launches and one host sync,
    and leaves no journal behind."""
    from repro_torch.core import engine as rt_engine
    syncs = []
    real = rt_engine._sync
    monkeypatch.setattr(rt_engine, "_sync", lambda x: syncs.append(1) or real(x))
    bare, _ = _engine(rt, surveys[1], on_fault="raise")
    tracked, _ = _engine(rt, surveys[1])
    want = bare.run(rt.CoaddQuery(**QUERY), "raw_fits", reduce=red)
    syncs.clear()
    got = tracked.run(rt.CoaddQuery(**QUERY), "raw_fits", reduce=red)
    assert len(syncs) == 1 and got.stats.retries == 0 and not tracked._journals
    _bitwise(got, want)
    assert got.stats.dispatches == want.stats.dispatches == got.stats.windows
    assert (got.stats.chunk_uploads, got.stats.residency_hits) == (
        want.stats.chunk_uploads, want.stats.residency_hits)
    assert tracked.event_waits == 0     # flags on the host need no event


def test_backups_on_threads_count_every_launch(surveys):
    """Every window after the first two speculated (a factor no window can
    stay under): backups dispatch from worker threads beside the main loop,
    under a switch interval short enough to interleave them anywhere.  The
    engine's launch counter loses no update (its increments run under the
    dispatch lock), every backup's digest agrees, and the sums are bitwise
    the clean run's."""
    import sys
    method = "sql_structured"
    _, n_windows = _query_shape(surveys, method, chunk_packs=1)
    eng, _ = _engine(rt, surveys[1], chunk_packs=1, straggler_factor=1e-9)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        d0 = eng.dispatch_count
        r = eng.run(rt.CoaddQuery(**QUERY), method)
    finally:
        sys.setswitchinterval(interval)
    assert r.stats.speculative_windows == n_windows - 2
    assert eng.dispatch_count - d0 == n_windows + r.stats.speculative_windows
    _bitwise(r, _clean(surveys, method, chunk_packs=1))


# ----- the CUDA path on a card ------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("drill", ["upload", "poison", "quarantine", "kill", "straggler",
                                   "seeded"])
def test_cuda_drills_bitwise_the_clean_kernel_path(cuda, surveys, drill):
    """Each drill kind on the kernel path, bitwise its clean streamed run on
    the card (the quarantine drill: depth exactly the plan-gated run)."""
    method = "sql_structured"
    packs, n_windows = _query_shape(surveys, method, chunk_packs=1)
    chunk = 1 if drill in ("straggler", "seeded") else 2
    sched = {"upload": dict(upload_fail=(0,)), "poison": dict(poison=((int(packs[0]), "nan", 1),)),
             "quarantine": dict(poison=((int(packs[0]), "nan", None),)), "kill": dict(kill=1),
             "straggler": dict(slow={n_windows - 1: 0.05})}.get(drill)
    if drill == "seeded":
        sched = rtc.FaultSchedule.seeded(seed=82, n_uploads=n_windows, n_windows=n_windows,
                                         gated_packs=packs, slow_s=0.05)
    elif sched is not None:
        sched = _schedule(rt, **sched)
    budget = (2 * chunk + 1) * _engine(rt, surveys[1])[0].exec_dataset("structured")[0] \
        .pack_nbytes()
    clean_eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cuda",
                               device_budget_bytes=budget)
    q = rt.CoaddQuery(**QUERY)
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cuda", device_budget_bytes=budget,
                         fault_backoff_s=1e-4, fault_injector=rtc.ChaosInjector(sched),
                         straggler_factor=3.0 if chunk == 1 else None,
                         on_fault="quarantine" if drill == "quarantine" else "retry")
    if drill == "kill":
        with pytest.raises(rtc.QueryKilled):
            eng.run(q, method)
    r = eng.run(q, method)
    if drill == "quarantine":
        plan = clean_eng.plan(q, method)
        plan.gate[int(packs[0])] = False
        np.testing.assert_array_equal(r.depth, clean_eng.execute(plan).depth)
        assert r.stats.uncovered_packs == (int(packs[0]),)
    else:
        _bitwise(r, clean_eng.run(q, method))
