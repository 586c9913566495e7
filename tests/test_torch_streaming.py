"""Streaming residency in the port (DESIGN.md §6), held against the JAX package.

Ports the non-distributed tests of ``tests/test_streaming.py`` onto
``repro_torch`` (``device="cpu"``, the plain path; ``use_kernel=True`` on
the CPU runs the kernels' plain versions), each against ``repro`` built with
``on_fault="raise"`` so that both packages run the bare window loop (the
port has no fault domain yet):

* the window schedule and its compacted gates bitwise the reference's;
* the `ResidencyManager`'s LRU, cost-aware eviction and peak accounting;
* streamed queries at 4x oversubscription for 6 methods x 3 estimators,
  unmatched and PSF-matched with both bank ranks, single and batched,
  dense, empty gates, eviction, repeat hits and one host sync a query:
  depth exactly, coadd at the reference's streaming tolerance (atol 5e-2 /
  rtol 1e-3, tests/test_streaming.py:129), windows, passes and the
  matched-chunk builds and hits as the reference counts them;
* brick tiles under a budget, spilled and re-served bitwise ``run_window``;
* the pack scans' index check on the host copy of the index.

The CUDA path runs only on a card: those tests carry the ``gpu`` marker and
skip here (``python3 chip_smoke.py`` drives it at full size).
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.plan as rc_plan
import repro_torch as rt
from repro_torch.core import engine as rt_engine
from repro_torch.core import plan as rt_plan
from repro_torch.core.seqfile import (COST_BRICK, COST_MATCHED_CHUNK, COST_RAW_CHUNK,
                                      ResidencyManager, finite_slots)
from repro_torch.kernels.warp import ops

CFG = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
QUERY = dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
QUERY2 = dict(band="r", ra_bounds=(37.3, 37.7), dec_bounds=(-0.4, 0.2), npix=32)
FAR = dict(band="r", ra_bounds=(200.0, 201.0), dec_bounds=(50.0, 51.0), npix=32)
ATOL, RTOL = 5e-2, 1e-3          # the reference's streaming tolerance
REDUCES = ("mean", "clipped", "median")
LATTICE = dict(brick_deg=0.5, brick_npix=16)


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


def _budget(eng, frac=4):
    """1/frac of the structured layout's bytes: the archive is frac x
    oversubscribed relative to the device budget."""
    ds = eng.exec_dataset("structured")[0]
    return max(ds.chunk_nbytes(0, ds.n_packs) // frac, 1)


def _budgeted(surveys, frac=4, **kw):
    """(reference, port) streaming engines, each at 1/frac of its own
    structured layout; the reference without its fault domain."""
    kw.setdefault("pack_capacity", 8)
    ref_probe = rc.CoaddEngine(surveys[0], pack_capacity=kw["pack_capacity"])
    port_probe = rt.CoaddEngine(surveys[1], pack_capacity=kw["pack_capacity"], device="cpu")
    return (rc.CoaddEngine(surveys[0], device_budget_bytes=_budget(ref_probe, frac),
                           on_fault="raise", **kw),
            rt.CoaddEngine(surveys[1], device_budget_bytes=_budget(port_probe, frac),
                           device="cpu", **kw))


@pytest.fixture(scope="module")
def streams(surveys):
    """Cached 4x-oversubscribed engine pairs, by PSF state."""
    cache = {}

    def get(psf=None, measured=None):
        if (psf, measured) not in cache:
            cache[psf, measured] = _budgeted(surveys, match_psf_sigma=psf, measured_psf=measured)
        return cache[psf, measured]

    return get


def _close(port, want):
    np.testing.assert_array_equal(port.depth, np.asarray(want.depth))
    np.testing.assert_allclose(port.coadd, np.asarray(want.coadd), atol=ATOL, rtol=RTOL)
    assert np.isfinite(port.coadd).all()


def _same_job(g, w):
    """The job's counts as the reference's."""
    assert (g.files_considered, g.files_contributing) == (w.files_considered,
                                                          w.files_contributing)
    assert (g.windows, g.reduce_passes, g.packs_scanned, g.scan_budget) == (
        w.windows, w.reduce_passes, w.packs_scanned, w.scan_budget)


# ----- residency machinery -------------------------------------------------

def test_window_schedule_chunks_and_budgets():
    gated = np.array([0, 1, 5, 9, 10, 11])
    wins = rt_plan.window_schedule(gated, n_packs=12, chunk_packs=4)
    assert [(w.start, w.stop) for w in wins] == [(0, 4), (4, 8), (8, 12)]
    assert [w.n_gated for w in wins] == [2, 1, 3]
    assert [w.budget for w in wins] == [2, 1, 4]
    assert list(wins[2].pack_idx) == [1, 2, 3, 0]
    wins = rt_plan.window_schedule(np.array([11]), 12, 4)
    assert [(w.start, w.stop) for w in wins] == [(8, 12)]
    empty = rt_plan.window_schedule(np.array([], np.int64), 12, 4)
    assert len(empty) == 1 and empty[0].budget == 1 and empty[0].n_gated == 0
    with pytest.raises(ValueError):
        rt_plan.window_schedule(gated, 12, 0)


@pytest.mark.parametrize("seed", range(4))
def test_window_schedule_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    n_packs, cap = int(rng.integers(1, 40)), int(rng.integers(1, 9))
    gate = rng.uniform(size=(n_packs, cap)) < 0.15
    gates = rng.uniform(size=(3, n_packs, cap)) < 0.1
    for g, any_packs in ((gate, gate.any(axis=1)), (gates, gates.any(axis=(0, 2)))):
        gated = np.nonzero(any_packs)[0]
        for chunk in (1, 3, 7, n_packs + 2):
            want = rc_plan.window_schedule(gated, n_packs, chunk)
            got = rt_plan.window_schedule(gated, n_packs, chunk)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.key == b.key and (a.start, a.stop) == (b.start, b.stop)
                assert a.pack_idx.dtype == b.pack_idx.dtype
                assert np.array_equal(a.pack_idx, b.pack_idx) and np.array_equal(a.sel, b.sel)
                if g.ndim == 2:
                    assert np.array_equal(rt_plan.compact_window_gate(g, a),
                                          rc_plan.compact_window_gate(g, b))
                else:
                    assert np.array_equal(rt_plan.compact_window_gates(g, a),
                                          rc_plan.compact_window_gates(g, b))


def test_residency_manager_lru_eviction_order():
    log = []
    mk = lambda name: (lambda: log.append(name) or name)  # noqa: E731
    mgr = ResidencyManager(budget_bytes=100)
    assert mgr.acquire(("a",), 40, mk("a")) == "a"
    assert mgr.acquire(("b",), 40, mk("b")) == "b"
    assert mgr.bytes_resident == 80 and mgr.uploads == 2
    assert mgr.acquire(("a",), 40, mk("a2")) == "a"
    assert mgr.hits == 1 and log == ["a", "b"]
    mgr.acquire(("c",), 40, mk("c"))
    assert mgr.evictions == 1 and mgr.bytes_resident == 80
    assert mgr.acquire(("a",), 40, mk("a3")) == "a"
    mgr.acquire(("b",), 40, mk("b2"))
    assert log == ["a", "b", "c", "b2"]
    mgr.acquire(("huge",), 500, mk("huge"))
    assert mgr.bytes_resident >= 500 and mgr.n_resident == 1
    mgr.clear()
    assert mgr.n_resident == 0 and mgr.bytes_resident == 0
    with pytest.raises(ValueError):
        ResidencyManager(budget_bytes=0)


def test_cost_aware_eviction_prefers_cheap_entries():
    mk = lambda name: (lambda: name)  # noqa: E731
    mgr = ResidencyManager(budget_bytes=300)
    mgr.acquire(("brick", 0), 100, mk("brick"), cost=COST_BRICK)
    mgr.acquire(("raw", 0), 100, mk("raw0"), cost=COST_RAW_CHUNK)
    mgr.acquire(("raw", 1), 100, mk("raw1"), cost=COST_RAW_CHUNK)
    evicted = []
    mgr.on_evict = lambda key, entry: evicted.append(key)
    mgr.acquire(("raw", 1), 100, mk("raw1-again"))
    mgr.acquire(("matched", 0), 100, mk("m0"), cost=COST_MATCHED_CHUNK)
    assert evicted == [("raw", 0)]
    mgr.acquire(("matched", 1), 100, mk("m1"), cost=COST_MATCHED_CHUNK)
    assert evicted == [("raw", 0), ("raw", 1)]
    mgr.acquire(("raw", 2), 100, mk("raw2"), cost=COST_RAW_CHUNK)
    assert evicted == [("raw", 0), ("raw", 1), ("matched", 0)]
    assert mgr.resident(("brick", 0))


# ----- parity: the port streamed against the reference streamed -----------

@pytest.mark.parametrize("method", rt.METHODS)
def test_streaming_matches_eager_4x_oversubscribed(surveys, streams, method):
    """An archive 4x the device budget: the port's streamed query against the
    reference's streamed query and the port's own eager one, every estimator."""
    ref_eng, port = streams()
    eager = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    for red in REDUCES:
        want = ref_eng.run(rc.CoaddQuery(**QUERY), method, reduce=red)
        got = port.run(rt.CoaddQuery(**QUERY), method, reduce=red)
        assert want.depth.max() > 0
        _close(got, want)
        _close(got, eager.run(rt.CoaddQuery(**QUERY), method, reduce=red))
        _same_job(got.stats, want.stats)
        s = got.stats
        assert s.reduce == red and s.reduce_passes == {"mean": 1, "clipped": 2, "median": 3}[red]
        assert s.windows >= 1 and s.dispatches == s.windows
        assert s.chunk_uploads <= s.windows
        assert port.residency.bytes_resident <= port.device_budget_bytes


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_streaming_matches_eager_with_kernel(surveys, use_kernel):
    """``use_kernel=True`` (the kernels' plain versions on the CPU) against
    the reference's Pallas path in interpret mode."""
    ref_eng, port = _budgeted(surveys, use_kernel=use_kernel)
    for method in ("sql_structured", "raw_fits_prefiltered"):
        _close(port.run(rt.CoaddQuery(**QUERY), method),
               ref_eng.run(rc.CoaddQuery(**QUERY), method))


def test_streaming_dense_scan_matches(surveys):
    ref_eng, port = _budgeted(surveys, sparse=False)
    want = ref_eng.run(rc.CoaddQuery(**QUERY), "sql_structured")
    got = port.run(rt.CoaddQuery(**QUERY), "sql_structured")
    _close(got, want)
    _same_job(got.stats, want.stats)
    assert got.stats.packs_scanned == port.exec_dataset("structured")[0].n_packs


@pytest.mark.parametrize("psf", [None, 2.0], ids=["unmatched", "psf"])
@pytest.mark.parametrize("red", REDUCES)
def test_streaming_batch_matches_eager(surveys, streams, red, psf):
    ref_eng, port = streams(psf)
    before = port.dispatch_count
    want = ref_eng.run_batch([rc.CoaddQuery(**QUERY), rc.CoaddQuery(**QUERY2)],
                             "sql_structured", reduce=red)
    got = port.run_batch([rt.CoaddQuery(**QUERY), rt.CoaddQuery(**QUERY2)],
                         "sql_structured", reduce=red)
    for g, w in zip(got, want):
        _close(g, w)
        _same_job(g.stats, w.stats)
    assert port.dispatch_count - before == got[0].stats.windows == got[0].stats.dispatches
    assert got[1].stats.dispatches == 0 and got[1].stats.packs_scanned == 0
    # Each query's own streamed run scans other windows: the key keeps apart.
    for q, g in zip((QUERY, QUERY2), got):
        own = port.run(rt.CoaddQuery(**q), "sql_structured", reduce=red)
        _close(g, own)
        plan = port.plan(rt.CoaddQuery(**q), "sql_structured", red)
        if g.stats.batch_scan:
            assert port.result_key(plan, g) != port.result_key(plan)
        else:
            np.testing.assert_array_equal(g.coadd, own.coadd)


def test_streaming_empty_gate(streams):
    _, port = streams()
    r = port.run(rt.CoaddQuery(**FAR), "sql_structured")
    assert np.all(r.coadd == 0) and np.all(r.depth == 0)
    assert not np.isnan(r.normalized).any()
    assert r.stats.windows == 0 and r.stats.scan_budget == 0
    assert r.stats.dispatches == 0 and r.stats.chunk_uploads == 0
    assert r.stats.files_considered == 0


def test_streaming_empty_gate_batch(streams):
    _, port = streams()
    for r in port.run_batch([rt.CoaddQuery(**FAR)] * 2, "sql_structured", reduce="median"):
        assert np.all(r.coadd == 0) and np.all(r.depth == 0)
        assert r.stats.windows == 0 and r.stats.dispatches == 0
        assert r.stats.chunk_uploads == 0 and r.stats.reduce == "median"


# ----- eviction correctness ---------------------------------------------------

def test_eviction_under_budget_smaller_than_layout(surveys):
    ref_eng, port = _budgeted(surveys)
    total = 0
    for q, m in [(QUERY, "sql_structured"), (QUERY2, "unstructured_seq"),
                 (QUERY, "raw_fits_prefiltered"), (QUERY2, "sql_structured"),
                 (QUERY, "sql_structured")]:
        want = ref_eng.run(rc.CoaddQuery(**q), m)
        got = port.run(rt.CoaddQuery(**q), m)
        _close(got, want)
        assert got.stats.residency_evictions == want.stats.residency_evictions
        total += got.stats.residency_evictions
        assert port.residency.bytes_resident <= port.device_budget_bytes
    assert total > 0


def test_repeat_query_hits_residency_no_reupload(surveys):
    """A budget of the layout's own bytes: two chunks of half of it, both
    resident after the first query."""
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    ds = probe.exec_dataset("unstructured")[0]
    stream = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                            device_budget_bytes=ds.chunk_nbytes(0, ds.n_packs))
    r1 = stream.run(rt.CoaddQuery(**QUERY), "unstructured_seq")
    assert r1.stats.windows > 1
    assert r1.stats.chunk_uploads == r1.stats.windows
    uploads = stream.pack_upload_count
    r2 = stream.run(rt.CoaddQuery(**QUERY), "unstructured_seq")
    assert r2.stats.chunk_uploads == 0
    assert r2.stats.residency_hits == r2.stats.windows
    assert r2.stats.residency_evictions == 0
    assert stream.pack_upload_count == uploads
    np.testing.assert_array_equal(r2.coadd, r1.coadd)


def test_streaming_blocks_only_at_reduce_time(surveys, monkeypatch):
    """Every window launch and chunk upload before the query's single host
    sync (`engine._sync`), for every estimator and for a batch."""
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    stream = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                            device_budget_bytes=_budget(probe))
    syncs = []
    real_sync = rt_engine._sync
    monkeypatch.setattr(rt_engine, "_sync", lambda x: syncs.append(1) or real_sync(x))
    for red in REDUCES:
        syncs.clear()
        r = stream.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce=red)
        assert r.stats.windows > r.stats.reduce_passes
        assert len(syncs) == 1
        syncs.clear()
        stream.run_batch([rt.CoaddQuery(**QUERY), rt.CoaddQuery(**QUERY2)], "sql_structured",
                         reduce=red)
        assert len(syncs) == 1


# ----- peak residency ----------------------------------------------------------

def test_peak_residency_pinned_under_4x_oversubscription(surveys):
    _, stream = _budgeted(surveys)
    r = stream.run(rt.CoaddQuery(**QUERY), "structured_seq_prefiltered")
    assert r.stats.residency_evictions > 0 or r.stats.windows >= 2
    peak = stream.residency.peak_bytes
    assert r.stats.peak_resident_bytes == peak > 0
    ds = stream.exec_dataset("structured")[0]
    chunk_bytes = ds.chunk_nbytes(0, stream._chunk_packs(ds))
    assert peak <= stream.device_budget_bytes + chunk_bytes, (peak, chunk_bytes)


def test_peak_residency_counts_in_flight_eviction():
    mgr = ResidencyManager(budget_bytes=100)
    mgr.acquire(("a",), 50, lambda: "A")
    mgr.acquire(("b",), 50, lambda: "B")
    mgr.acquire(("c",), 50, lambda: "C")
    assert mgr.evictions == 1 and mgr.peak_bytes == 100
    mgr.acquire(("d",), 100, lambda: "D")
    assert mgr.evictions == 3 and mgr.peak_bytes == 150
    mgr.acquire(("e",), 100, lambda: "E", transient_bytes=30)
    assert mgr.peak_bytes == 230


def test_peak_residency_includes_matched_cache(surveys):
    """The plain path's eager matched copy is device bytes too, built on the
    device without an upload: the peak counts the layout and its copy."""
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", use_kernel=False,
                         match_psf_sigma=2.0)
    r = eng.run(rt.CoaddQuery(**QUERY), "sql_structured")
    dev = eng.device_dataset("structured")
    assert eng.residency.uploads == 0 and eng.matched_builds == 1
    assert r.stats.peak_resident_bytes >= 2 * dev.pixels.numel() * dev.pixels.element_size()


# ----- PSF-matched streaming: the chunk is the matched cache ------------------

@pytest.mark.parametrize("measured", [False, True], ids=["sep", "2d"])
@pytest.mark.parametrize("method", rt.METHODS)
def test_psf_matched_streaming_matches_reference(streams, method, measured):
    """Both bank ranks, every estimator; a matched build per uploaded chunk
    and a hit per resident one, as the reference counts them."""
    ref_eng, port = streams(2.0, measured)
    for red in REDUCES:
        want = ref_eng.run(rc.CoaddQuery(**QUERY), method, reduce=red)
        got = port.run(rt.CoaddQuery(**QUERY), method, reduce=red)
        _close(got, want)
        _same_job(got.stats, want.stats)
        g, w = got.stats, want.stats
        assert (g.chunk_uploads, g.residency_hits) == (w.chunk_uploads, w.residency_hits)
        assert (g.matched_cache_builds, g.matched_cache_hits) == (w.matched_cache_builds,
                                                                   w.matched_cache_hits)
        assert g.matched_cache_builds == g.chunk_uploads and g.dispatches == g.windows


def test_psf_streaming_kernel_path_builds_each_chunk_once(surveys):
    """On the kernel path too the chunk is the matched cache: one ungated
    pre-pass per uploaded chunk (a matched build, not a pass), none for a
    resident one.  The budget holds the layout and its bank: two chunks, both
    resident after the first query."""
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", match_psf_sigma=2.0)
    ds = probe.exec_dataset("unstructured")[0]
    budget = ds.chunk_nbytes(0, ds.n_packs) + ds.n_packs * probe._bank_pack_nbytes(ds.layout)
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", match_psf_sigma=2.0,
                         device_budget_bytes=budget)
    eager = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", match_psf_sigma=2.0)
    r1 = eng.run(rt.CoaddQuery(**QUERY), "unstructured_seq", reduce="median")
    assert r1.stats.matched_cache_builds == r1.stats.chunk_uploads == r1.stats.windows // 3
    assert r1.stats.dispatches == r1.stats.windows
    r2 = eng.run(rt.CoaddQuery(**QUERY), "unstructured_seq", reduce="median")
    assert r2.stats.matched_cache_builds == r2.stats.chunk_uploads == 0
    assert r2.stats.matched_cache_hits == r2.stats.windows
    np.testing.assert_array_equal(r2.coadd, r1.coadd)
    _close(r1, eager.run(rt.CoaddQuery(**QUERY), "unstructured_seq", reduce="median"))


# ----- bricks under a budget ---------------------------------------------------

def _region(grid, r0, r1, c0, c1):
    eps = 1e-9
    return ((grid.ra0 + c0 * grid.brick_deg + eps, grid.ra0 + c1 * grid.brick_deg - eps),
            (grid.dec0 + r0 * grid.brick_deg + eps, grid.dec0 + r1 * grid.brick_deg - eps))


@pytest.mark.parametrize("red", ["mean", "median"])
def test_budgeted_bricks_spill_and_reserve_bitwise(surveys, red):
    """Bricks materialized by streamed scans under a budget so small that
    every insert evicts: the warm query re-serves spilled tiles from the
    host tier, one mosaic, bitwise ``run_window``; and close to the
    reference's budgeted brick engine."""
    ref_eng = rc.CoaddEngine(surveys[0], pack_capacity=8, device_budget_bytes=1,
                             on_fault="raise", **LATTICE)
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", device_budget_bytes=1,
                         **LATTICE)
    region = _region(eng.brick_grid, 1, 3, 0, 2)
    rep = eng.materialize_bricks(bands=("r",), region=region, reduce=red)
    assert rep.completed == 4
    wq = eng.brick_grid.window_query(1, 3, 0, 2, "r")
    fresh = eng.run_window(wq, "sql_structured", red)
    assert fresh.stats.windows >= 2 and fresh.depth.max() > 0
    before = ops.mosaic_bricks.launches
    warm = eng.run(wq, "sql_structured", use_bricks=True, reduce=red)
    assert (warm.stats.bricks_hit, warm.stats.bricks_missed) == (0, 0)
    assert warm.stats.bricks_spilled == 4 and eng.brick_store.spilled > 0
    assert warm.stats.dispatches == 1 and ops.mosaic_bricks.launches == before  # plain on the CPU
    np.testing.assert_array_equal(warm.coadd, fresh.coadd)
    np.testing.assert_array_equal(warm.depth, fresh.depth)
    rwq = ref_eng.brick_grid.window_query(1, 3, 0, 2, "r")
    _close(warm, ref_eng.run(rwq, "sql_structured", use_bricks=True, reduce=red))


def test_streamed_materialization_matches_the_eager_bricks(surveys):
    """`materialize_bricks` under a budget streams its misses; the tiles are
    the eager engine's within the streaming tolerance, depth exactly."""
    eager = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", **LATTICE)
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                         device_budget_bytes=_budget(probe), **LATTICE)
    region = _region(eng.brick_grid, 1, 3, 0, 2)
    eng.materialize_bricks(bands=("r",), region=region)
    eager.materialize_bricks(bands=("r",), region=region)
    assert set(eng.brick_store.keys()) == set(eager.brick_store.keys())
    for key in eng.brick_store.keys():
        (c, d), (ce, de) = eng.brick_store.host_arrays(key), eager.brick_store.host_arrays(key)
        np.testing.assert_array_equal(d, de)
        np.testing.assert_allclose(c, ce, atol=ATOL, rtol=RTOL)


# ----- the result key and the engine's arguments ------------------------------

def test_result_key_carries_the_budget(surveys, streams):
    _, port = streams()
    eager = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    plan = port.plan(rt.CoaddQuery(**QUERY), "sql_structured")
    assert port.result_key(plan) != eager.result_key(plan)
    assert f"|b{port.device_budget_bytes}" in port.result_key(plan)


# ----- the pack scans check the index on its host copy ------------------------

def _scan(n_packs=3, cap=2, g=4, q=8):
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.normal(size=(n_packs, cap, 6, 6)).astype(np.float32))
    wcs = torch.zeros((n_packs, cap, 8), dtype=torch.float32)
    host = rng.integers(0, n_packs, g).astype(np.int32)
    idx = torch.from_numpy(host.copy())
    accept = torch.ones((g, cap), dtype=torch.float32)
    grid = torch.zeros((q, q), dtype=torch.float32)
    return (pixels, wcs, idx, accept, grid, grid.clone()), host


def test_pack_scans_check_the_host_index_without_a_device_reduction(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.aminmax called on the pack index")

    monkeypatch.setattr(torch, "aminmax", boom)
    scan, host = _scan()
    bank = torch.ones((3, 2, 1), dtype=torch.float32)
    c, d = ops.coadd_fused(*scan, host_idx=host)
    assert c.shape == (8, 8)
    ops.coadd_moments(*scan, host_idx=host)
    ops.coadd_fused(*scan, psf_kernels=bank, host_idx=host)
    ops.psf_match(scan[0], scan[2], bank, host_idx=host)
    ops.coadd_fused(*scan)                      # a CPU index is read in place
    bad = host.copy()
    bad[1] = 3
    with pytest.raises(IndexError, match="spans"):
        ops.coadd_fused(*scan, host_idx=bad)
    with pytest.raises(IndexError, match="spans"):
        ops.psf_match_sep(scan[0], scan[2], bank, host_idx=bad)
    neg = host.copy()
    neg[0] = -1
    with pytest.raises(IndexError):
        ops.coadd_clip(*scan, scan[4], scan[4], host_idx=neg)
    with pytest.raises(ValueError, match="host_idx"):
        ops.coadd_fused(*scan, host_idx=host[:2])


def test_engine_passes_the_host_index(surveys, monkeypatch):
    """The engine's passes hand every pack scan its host index, so a launch
    never reads the device index back."""
    seen = []
    real = ops._check_pack_idx
    monkeypatch.setattr(ops, "_check_pack_idx",
                        lambda idx, n, host_idx=None: seen.append(host_idx is not None)
                        or real(idx, n, host_idx))
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", match_psf_sigma=2.0)
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    stream = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", match_psf_sigma=2.0,
                            device_budget_bytes=_budget(probe))
    for e in (eng, stream):
        e.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce="median")
        e.run_batch([rt.CoaddQuery(**QUERY), rt.CoaddQuery(**QUERY2)], "raw_fits")
    assert seen and all(seen)


# ----- the chunk upload -------------------------------------------------------------

def test_device_chunk_is_the_layout_range_with_its_flag(surveys):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    ds = eng.exec_dataset("unstructured")[0]
    ds.pixels[1, 0, 3, 3] = np.nan
    try:
        chunk = ds.to_device_chunk(1, 3, "cpu")
        assert np.array_equal(chunk.pixels.numpy(), ds.pixels[1:3], equal_nan=True)
        assert np.array_equal(chunk.wcs.numpy(), ds.wcs[1:3])
        for k in ds.ints:
            assert np.array_equal(chunk.ints[k].numpy(), ds.ints[k][1:3])
        for k in ds.floats:
            assert np.array_equal(chunk.floats[k].numpy(), ds.floats[k][1:3])
        assert np.array_equal(chunk.finite.numpy(),
                              finite_slots(torch.from_numpy(ds.pixels[1:3])).numpy())
        assert chunk.finite[0, 0] == 0
        assert chunk.nbytes == ds.chunk_nbytes(1, 3) and chunk.ready is None
    finally:
        ds.pixels[1, 0, 3, 3] = 0.0


def test_budgeted_engine_plans_and_streams(surveys):
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                         device_budget_bytes=_budget(probe))
    r = eng.run(rt.CoaddQuery(**QUERY), "unstructured_seq")
    assert r.stats.windows > 1 and eng.pack_upload_count == r.stats.chunk_uploads
    assert not eng._device_cache                 # no layout uploaded whole


# ----- the CUDA path on a card --------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("psf", [None, 2.0])
@pytest.mark.parametrize("red", REDUCES)
def test_cuda_streamed_kernel_path_matches_eager(cuda, surveys, red, psf):
    eager = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cuda", match_psf_sigma=psf)
    probe = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    stream = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cuda", match_psf_sigma=psf,
                            device_budget_bytes=_budget(probe))
    for method in rt.METHODS:
        _close(stream.run(rt.CoaddQuery(**QUERY), method, reduce=red),
               eager.run(rt.CoaddQuery(**QUERY), method, reduce=red))
    got = stream.run_batch([rt.CoaddQuery(**QUERY), rt.CoaddQuery(**QUERY2)], "sql_structured",
                           reduce=red)
    want = eager.run_batch([rt.CoaddQuery(**QUERY), rt.CoaddQuery(**QUERY2)], "sql_structured",
                           reduce=red)
    for g, w in zip(got, want):
        _close(g, w)
