"""The port's brick tier, held against the JAX package's (DESIGN.md §9).

On the reference's own test survey and lattice (tests/test_bricks.py:
``brick_deg=0.5``, ``brick_npix=16``):

* the tessellation (`BrickGrid`) is bitwise the reference's, including the
  random-footprint property loop;
* the mosaic's plain version is bitwise the reference's XLA scan and its
  Pallas kernel (interpret mode), with overlapping tiles and clamped
  offsets;
* for six methods x three estimators, plus PSF-matched: a brick-served
  query (cold, warm, spilled) equals ``run_window`` bitwise within the port,
  an unaligned query falls back, a retuned PSF state misses, and the port's
  window scan and mosaic agree with the reference's at atol 2e-2 /
  rtol 1e-4 with depth exact, with the brick counters equal.  The port
  launches one kernel a pass (and one ``psf_match`` a matched query) where
  the reference dispatches one fused program a query, so ``dispatches``
  equals the reference's on the mean path and on every warm serve (1), and
  counts passes otherwise;
* a `ResidencyManager` + `BrickStore` sequence under a small budget gives
  the reference's counters;
* `MaterializeTracker` retries a transient fault, lets a fatal one escape,
  and a rerun skips finished bricks.

The reference's streaming and quarantine brick cases (tests/test_bricks.py
``test_partial_brick_propagates_into_mosaic`` and
``test_materialize_survives_kill_and_resume``) need the streaming
executors and the fault domain, which the port does not have yet.
"""
import builtins

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
from repro.core import reducer as rc_reducer
from repro.core import seqfile as rc_seqfile
from repro.core import faults as rc_faults
from repro.core import jobtracker as rc_jobtracker
from repro.kernels.warp import ops as rc_ops
from repro_torch.core import faults, jobtracker, reducer, seqfile
from repro_torch.kernels.warp import ops, ref

ATOL, RTOL = 2e-2, 1e-4
CFG = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
LATTICE = dict(brick_deg=0.5, brick_npix=16)
WINDOW = (1, 3, 0, 2)
REDUCES = ("mean", "clipped", "median")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors in parallel worker processes: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


@pytest.fixture(scope="module")
def engines(surveys):
    """(reference, port) engine pairs, one per PSF target, reused across
    tests; each case clears both brick stores first."""
    cache = {}

    def get(psf=None):
        if psf not in cache:
            cache[psf] = (
                rc.CoaddEngine(surveys[0], pack_capacity=8, match_psf_sigma=psf, **LATTICE),
                rt.CoaddEngine(surveys[1], pack_capacity=8, match_psf_sigma=psf, device="cpu",
                               **LATTICE),
            )
        for eng in cache[psf]:
            eng.brick_store.clear()
        return cache[psf]

    return get


def _region(grid, r0, r1, c0, c1):
    """A (ra_bounds, dec_bounds) region intersecting exactly these cells."""
    eps = 1e-9
    return ((grid.ra0 + c0 * grid.brick_deg + eps, grid.ra0 + c1 * grid.brick_deg - eps),
            (grid.dec0 + r0 * grid.brick_deg + eps, grid.dec0 + r1 * grid.brick_deg - eps))


def _equal(a, b):
    np.testing.assert_array_equal(a.coadd, b.coadd)
    np.testing.assert_array_equal(a.depth, b.depth)


def _close(port, want):
    np.testing.assert_allclose(port.coadd, np.asarray(want.coadd), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(port.depth, np.asarray(want.depth))
    assert np.isfinite(port.coadd).all()


# ----- tessellation: bitwise the reference's --------------------------------

def _grids(*args, **kw):
    return rc.BrickGrid.for_bounds(*args, **kw), rt.BrickGrid.for_bounds(*args, **kw)


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_tessellation_covers_random_footprints_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        ra0 = float(rng.uniform(0, 300))
        dec0 = float(rng.uniform(-10, 10))
        ra_span = float(rng.uniform(0.3, 4.0))
        dec_span = float(rng.uniform(0.3, 4.0))
        bd = float(rng.choice([0.25, 0.5, 1.0]))
        want, grid = _grids(ra0, dec0, ra_span, dec_span, brick_deg=bd, brick_npix=8)
        assert (grid.n_rows, grid.n_cols, grid.scale) == (want.n_rows, want.n_cols, want.scale)
        assert grid.n_cols * bd >= ra_span - 1e-9 and grid.n_rows * bd >= dec_span - 1e-9
        for _ in range(50):
            ra = ra0 + float(rng.uniform(0, ra_span))
            dec = dec0 + float(rng.uniform(0, dec_span))
            cell = grid.locate(ra, dec)
            assert cell is not None and cell == want.locate(ra, dec)
            lo_ra, hi_ra, lo_dec, hi_dec = grid.nominal_box(*cell)
            assert (lo_ra, hi_ra, lo_dec, hi_dec) == want.nominal_box(*cell)
            assert lo_ra <= ra < hi_ra and lo_dec <= dec < hi_dec
        assert grid.locate(ra0 - bd, dec0) is None and want.locate(ra0 - bd, dec0) is None
        if grid.n_cols > 1:
            assert grid.nominal_box(0, 0)[1] == grid.nominal_box(0, 1)[0]
        if grid.n_rows > 1:
            assert grid.nominal_box(0, 0)[3] == grid.nominal_box(1, 0)[2]


def test_grids_bounds_and_queries_bitwise():
    want, grid = _grids(37.0, -1.0, 1.5, 1.0, brick_deg=0.5, brick_npix=8)
    np.testing.assert_array_equal(grid.lattice_wcs().to_vector(), want.lattice_wcs().to_vector())
    b = grid.brick_npix
    full = grid.window_sky(0, grid.n_rows, 0, grid.n_cols)
    for a, w in zip(full, want.window_sky(0, want.n_rows, 0, want.n_cols)):
        np.testing.assert_array_equal(a, w)
    for r in range(grid.n_rows):
        for c in range(grid.n_cols):
            for t, w, f in zip(grid.brick_sky(r, c), want.brick_sky(r, c), full):
                np.testing.assert_array_equal(t, w)
                np.testing.assert_array_equal(t, f[r * b:(r + 1) * b, c * b:(c + 1) * b])
            assert grid.brick_bounds(r, c) == want.brick_bounds(r, c)
    for win in ((0, 2, 1, 3), (1, 2, 0, 1), (0, 2, 0, 2)):
        assert grid.window_bounds(*win) == want.window_bounds(*win)
        q, qw = grid.window_query(*win, "g"), want.window_query(*win, "g")
        assert (q.band, q.ra_bounds, q.dec_bounds, q.npix) == (
            qw.band, qw.ra_bounds, qw.dec_bounds, qw.npix)
        cover = grid.decompose(q)
        assert (cover.r0, cover.r1, cover.c0, cover.c1) == win
        assert cover.bricks == want.decompose(qw).bricks and cover.tag == want.decompose(qw).tag
    with pytest.raises(ValueError):
        grid.window_query(0, 2, 0, 1, "g")          # not square
    with pytest.raises(ValueError):
        grid.window_sky(0, grid.n_rows + 1, 0, 1)   # off the lattice


def test_decompose_refuses_what_the_reference_refuses():
    want, grid = _grids(37.0, -1.0, 1.5, 1.0, brick_deg=0.5, brick_npix=8)
    w = grid.window_query(0, 1, 0, 1, "g")
    queries = [
        dict(band="g", ra_bounds=(37.1, 37.9), dec_bounds=(-0.9, -0.1), npix=16),
        dict(band="g", ra_bounds=w.ra_bounds, dec_bounds=w.dec_bounds, npix=w.npix,
             time_bounds=(0.0, 1.0)),
        dict(band="g", ra_bounds=w.ra_bounds, dec_bounds=w.dec_bounds, npix=w.npix + 1),
        dict(band="g", ra_bounds=(w.ra_bounds[0] + 1e-5, w.ra_bounds[1]),
             dec_bounds=w.dec_bounds, npix=w.npix),
    ]
    for kw in queries:
        assert grid.decompose(rt.CoaddQuery(**kw)) is None
        assert want.decompose(rc.CoaddQuery(**kw)) is None


def test_survey_lattice_and_regions_bitwise(surveys):
    cfg = rt.SurveyConfig(**CFG)
    grid = rt.BrickGrid.for_survey(cfg, **LATTICE)
    want = rc.BrickGrid.for_survey(rc.SurveyConfig(**CFG), **LATTICE)
    assert (grid.ra0, grid.dec0, grid.n_rows, grid.n_cols) == (
        want.ra0, want.dec0, want.n_rows, want.n_cols)
    assert grid.bricks() == want.bricks()
    for win in ((1, 3, 0, 2), (0, 1, 0, 1), (0, grid.n_rows, 1, 2)):
        region = _region(grid, *win)
        assert grid.bricks(region) == want.bricks(region)
        assert len(grid.bricks(region)) == (win[1] - win[0]) * (win[3] - win[2])


# ----- the mosaic: plain version bitwise the reference's ---------------------

def _mosaic_case(name):
    """(tiles, covs, offsets, npix) of one mosaic case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "lattice":
        b, npix = 8, 16
        offsets = [[0, 0], [0, 8], [8, 0], [8, 8]]
        shape = (4, b, b)
    elif name == "one_tile":
        offsets, shape, npix = [[3, 5]], (1, 8, 8), 16
    elif name == "bh_ne_bw":
        offsets, shape, npix = [[0, 0], [4, 8], [8, 1]], (3, 6, 10), 20
    elif name == "overlapping":
        offsets, shape, npix = [[0, 0], [2, 3], [1, 1], [2, 3], [5, 0]], (5, 8, 8), 16
    elif name == "clamped":
        # Past the far edge: clamped; negative: counted once from the end,
        # then clamped (-20 -> -4 -> 0), as the reference's dynamic_slice.
        offsets = [[-3, 0], [0, 40], [100, -7], [9, 9], [-1, 12], [-20, 3]]
        shape, npix = (6, 8, 7), 16
    elif name == "uncovered":
        offsets, shape, npix = [[0, 0], [20, 20]], (2, 8, 8), 37
    # The CUDA kernel's float4 and scalar paths (bricks whose clamped
    # column and width are multiples of 4 take the float4 one).
    elif name == "lattice_vec":
        offsets = [[r * 64, c * 64] for r in range(4) for c in range(4)]
        shape, npix = (16, 64, 64), 256
    elif name == "column_not_4":
        offsets = [[0, 3], [10, 6], [30, 13], [-5, 70], [64, 0]]
        shape, npix = (5, 24, 16), 80
    elif name == "width_not_4":
        offsets = [[0, 0], [4, 8], [20, 40], [-3, -9]]
        shape, npix = (4, 20, 10), 68
    elif name == "npix_not_4":
        offsets = [[0, 0], [0, 16], [16, 48], [50, 50], [-1, -1]]
        shape, npix = (5, 16, 16), 66
    elif name == "many_bricks":
        offsets = rng.integers(-90, 90, (300, 2))
        shape, npix = (300, 8, 12), 70
    elif name == "mixed_overlap":
        offsets = [[0, 0], [2, 4], [2, 5], [-8, -4], [7, 9], [0, 64], [33, 32]]
        shape, npix = (7, 32, 32), 96
    offsets = np.asarray(offsets, np.int32)
    tiles = rng.normal(size=shape).astype(np.float32)
    covs = rng.integers(0, 4, size=shape).astype(np.float32)
    return tiles, covs, offsets, npix


MOSAIC_CASES = ("lattice", "one_tile", "bh_ne_bw", "overlapping", "clamped", "uncovered")
#: Shapes that split the CUDA kernel's float4 and scalar paths: a clamped
#: column not a multiple of 4, bw % 4 != 0, npix % 4 != 0, more than 256
#: bricks (the filter's chunks), overlaps and negative offsets.
KERNEL_MOSAIC_CASES = ("lattice_vec", "column_not_4", "width_not_4", "npix_not_4",
                       "many_bricks", "mixed_overlap")


@pytest.mark.parametrize("name", MOSAIC_CASES)
def test_plain_mosaic_bitwise_the_reference_scan(name):
    tiles, covs, offsets, npix = _mosaic_case(name)
    xc, xd = rc_reducer.mosaic_tiles(tiles, covs, offsets, npix)
    c, d = reducer.mosaic_tiles(*map(torch.from_numpy, (tiles, covs, offsets)), npix)
    np.testing.assert_array_equal(c.numpy(), np.asarray(xc))
    np.testing.assert_array_equal(d.numpy(), np.asarray(xd))
    # The wrapper on CPU tensors is the plain version, and counts nothing.
    before = ops.mosaic_bricks.launches
    wc, wd = ops.mosaic_bricks(*map(torch.from_numpy, (tiles, covs, offsets)), npix)
    assert ops.mosaic_bricks.launches == before
    assert torch.equal(wc, c) and torch.equal(wd, d)


@pytest.mark.parametrize("name", ("lattice", "one_tile", "overlapping", "clamped"))
def test_plain_mosaic_bitwise_the_pallas_kernel(name):
    tiles, covs, offsets, npix = _mosaic_case(name)
    kc, kd = rc_ops.mosaic_bricks(tiles, covs, offsets, npix)
    c, d = ref.mosaic_bricks_ref(*map(torch.from_numpy, (tiles, covs, offsets)), npix)
    np.testing.assert_array_equal(c.numpy(), np.asarray(kc))
    np.testing.assert_array_equal(d.numpy(), np.asarray(kd))


def test_empty_mosaic_is_zero_canvases():
    tiles = np.zeros((0, 4, 4), np.float32)
    offsets = np.zeros((0, 2), np.int32)
    xc, xd = rc_reducer.mosaic_tiles(tiles, tiles, offsets, 8)
    c, d = ops.mosaic_bricks(torch.from_numpy(tiles), torch.from_numpy(tiles),
                             torch.from_numpy(offsets), 8)
    assert c.shape == d.shape == (8, 8) and not c.any() and not d.any()
    np.testing.assert_array_equal(c.numpy(), np.asarray(xc))


@pytest.mark.parametrize("bad, err", [
    (dict(npix=7), ValueError),                                   # tiles larger than canvas
    (dict(tiles=torch.zeros(2, 8, 8, dtype=torch.float64)), ValueError),
    (dict(offsets=torch.zeros(2, 2, dtype=torch.int64)), ValueError),
    (dict(offsets=torch.zeros(3, 2, dtype=torch.int32)), ValueError),
    (dict(covs=torch.zeros(2, 8, 4)), ValueError),
    (dict(tiles=torch.zeros(2, 16, 8).transpose(1, 2)), ValueError),   # not contiguous
    (dict(tiles=np.zeros((2, 8, 8), np.float32)), TypeError),
    (dict(npix=0), ValueError),
])
def test_mosaic_wrapper_rejects_bad_operands(bad, err):
    args = dict(tiles=torch.zeros(2, 8, 8), covs=torch.zeros(2, 8, 8),
                offsets=torch.zeros(2, 2, dtype=torch.int32), npix=16)
    args.update(bad)
    with pytest.raises(err):
        ops.mosaic_bricks(**args)


# ----- the engine: mosaic == run_window, and both == the reference ----------

def _brick_case(engines, method, reduce, psf=None):
    ref_eng, eng = engines(psf)
    wq, wq_ref = eng.brick_grid.window_query(*WINDOW, "r"), ref_eng.brick_grid.window_query(
        *WINDOW, "r")
    fresh, want_fresh = eng.run_window(wq, method, reduce), ref_eng.run_window(
        wq_ref, method, reduce)
    cold = eng.run(wq, method, use_bricks=True, reduce=reduce)
    want_cold = ref_eng.run(wq_ref, method, use_bricks=True, reduce=reduce)
    warm = eng.run(wq, method, use_bricks=True, reduce=reduce)
    want_warm = ref_eng.run(wq_ref, method, use_bricks=True, reduce=reduce)
    assert eng.brick_store.drop_device() == 4
    spilled = eng.run(wq, method, use_bricks=True, reduce=reduce)
    # Within the port: every serve is the fresh window scan, bitwise.
    for res in (cold, warm, spilled):
        _equal(res, fresh)
    # Against the reference: the window scan and the mosaic.
    _close(fresh, want_fresh)
    _close(warm, want_warm)
    for res, want in ((cold, want_cold), (warm, want_warm)):
        s, w = res.stats, want.stats
        assert (s.bricks_hit, s.bricks_missed, s.bricks_spilled, s.residual_packs_scanned) == (
            w.bricks_hit, w.bricks_missed, w.bricks_spilled, w.residual_packs_scanned)
        assert (s.files_considered, s.files_contributing) == (
            w.files_considered, w.files_contributing)
        assert (s.partial, s.uncovered_packs) == (w.partial, w.uncovered_packs) == (False, ())
    assert (cold.stats.bricks_missed, warm.stats.bricks_hit) == (4, 4)
    assert cold.stats.residual_packs_scanned > 0 == warm.stats.residual_packs_scanned
    assert (spilled.stats.bricks_spilled, spilled.stats.bricks_hit,
            spilled.stats.bricks_missed, spilled.stats.residual_packs_scanned) == (4, 0, 0, 0)
    assert warm.stats.dispatches == spilled.stats.dispatches == want_warm.stats.dispatches == 1
    launches = {"mean": 1, "clipped": 2, "median": 3}[reduce] + (psf is not None)
    assert cold.stats.dispatches == 4 * launches + 1
    if launches == 1:
        assert cold.stats.dispatches == want_cold.stats.dispatches
    return eng, fresh


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("method", rt.METHODS)
def test_mosaic_matches_window_and_reference(engines, method, reduce):
    _brick_case(engines, method, reduce)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("method", ["sql_structured", "raw_fits"])
def test_psf_matched_mosaic_matches_window_and_reference(engines, method, reduce):
    _brick_case(engines, method, reduce, psf=2.0)


@pytest.mark.parametrize("reduce", REDUCES)
def test_plain_path_mosaic_matches_window(surveys, reduce):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, use_kernel=False, device="cpu", **LATTICE)
    wq = eng.brick_grid.window_query(*WINDOW, "r")
    fresh = eng.run_window(wq, "sql_structured", reduce)
    cold = eng.run(wq, "sql_structured", use_bricks=True, reduce=reduce)
    warm = eng.run(wq, "sql_structured", use_bricks=True, reduce=reduce)
    _equal(cold, fresh)
    _equal(warm, fresh)
    assert warm.stats.bricks_hit == 4 and warm.stats.dispatches == 1


def test_unaligned_query_falls_back(engines):
    ref_eng, eng = engines()
    kw = dict(band="r", ra_bounds=(37.0, 37.3), dec_bounds=(-0.5, -0.2), npix=48)
    plain = eng.run(rt.CoaddQuery(**kw), "sql_structured")
    fb = eng.run(rt.CoaddQuery(**kw), "sql_structured", use_bricks=True)
    want = ref_eng.run(rc.CoaddQuery(**kw), "sql_structured", use_bricks=True)
    _equal(fb, plain)
    _close(fb, want)
    assert (fb.stats.bricks_hit, fb.stats.bricks_missed) == (0, 0) == (
        want.stats.bricks_hit, want.stats.bricks_missed)
    assert len(eng.brick_store) == 0
    with pytest.raises(ValueError, match="brick-aligned"):
        eng.run_window(rt.CoaddQuery(**kw), "sql_structured")


def test_bricks_key_on_psf_state_and_estimator(surveys):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", **LATTICE)
    ref_eng = rc.CoaddEngine(surveys[0], pack_capacity=8, **LATTICE)
    wq = eng.brick_grid.window_query(*WINDOW, "r")
    eng.run(wq, "sql_structured", use_bricks=True)
    assert eng.warm_brick_cover(wq) is not None
    assert eng.warm_brick_cover(wq, "clipped") is None     # per estimator
    r = eng.run(wq, "sql_structured", use_bricks=True, reduce="clipped")
    assert r.stats.bricks_missed == 4
    # Retune: same store, another PSF state; every key must miss.
    eng.match_psf_sigma = ref_eng.match_psf_sigma = 2.0
    assert eng.warm_brick_cover(wq) is None
    r = eng.run(wq, "sql_structured", use_bricks=True)
    assert (r.stats.bricks_missed, r.stats.bricks_hit) == (4, 0)
    _equal(r, eng.run_window(wq, "sql_structured"))
    for red in REDUCES:
        assert eng._brick_key("r", 1, 0, red) == ref_eng._brick_key("r", 1, 0, red)
    assert len(eng.brick_store) == 12


def test_materialize_bricks_and_rerun_skip(engines):
    ref_eng, eng = engines()
    region = _region(eng.brick_grid, *WINDOW)
    rep = eng.materialize_bricks(bands=("r",), region=region)
    want = ref_eng.materialize_bricks(bands=("r",), region=region)
    assert [(t.band, t.row, t.col, t.status, t.packs_scanned) for t in rep.tasks] == [
        (t.band, t.row, t.col, t.status, t.packs_scanned) for t in want.tasks]
    assert (rep.completed, rep.skipped, rep.partial_bricks) == (4, 0, 0)
    for key in eng.brick_store.keys():
        c, d = eng.brick_store.host_arrays(key)
        wc, wd = ref_eng.brick_store.host_arrays(key)
        np.testing.assert_allclose(c, wc, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(d, wd)
        m, wm = eng.brick_store.meta(key), ref_eng.brick_store.meta(key)
        assert (m.files_considered, m.files_contributing, m.partial, m.uncovered_packs) == (
            wm.files_considered, wm.files_contributing, wm.partial, wm.uncovered_packs)
    again = eng.materialize_bricks(bands=("r",), region=region)
    assert (again.completed, again.skipped) == (0, 4)
    wq = eng.brick_grid.window_query(*WINDOW, "r")
    assert eng.warm_brick_cover(wq) is not None
    warm = eng.run(wq, "sql_structured", use_bricks=True)
    assert warm.stats.bricks_hit == 4 and warm.stats.dispatches == 1
    _equal(warm, eng.run_window(wq, "sql_structured"))
    # The brick tier counts toward the engine's resident bytes.
    assert eng.residency.bytes_resident == 4 * 2 * 16 * 16 * 4
    assert eng.resident_bytes >= eng.residency.bytes_resident


# ----- residency: the reference's counters under a small budget -------------

def _residency_sequence(pkg, store_kw):
    brick = 2 * 8 * 8 * 4
    rm = pkg.ResidencyManager(budget_bytes=3 * brick + 100)
    store = pkg.BrickStore(rm, **store_kw)
    ones = np.ones((8, 8), np.float32)
    log = []
    for i in range(3):
        store.put(("brick", "r", 0, i, None), ones * i, ones)
    # A raw chunk (the cheapest rebuild class) shares the budget and goes
    # first under pressure; then the least recently used bricks spill.
    rm.acquire(("structured", 0, 1), 100, lambda: "chunk")
    store.put(("brick", "r", 0, 3, None), ones * 3, ones)
    store.put(("brick", "r", 0, 4, None), ones * 4, ones)
    log.append(store.fetch(("brick", "r", 0, 0, None))[3])  # host: re-upload
    log.append(store.fetch(("brick", "r", 0, 4, None))[3])  # device
    log.append(store.fetch(("brick", "r", 9, 9, None)))     # miss
    log.append(store.drop_device())
    log.append(store.fetch(("brick", "r", 0, 2, None))[3])
    log.append(float(np.asarray(store.fetch(("brick", "r", 0, 3, None))[0]).sum()))
    log.append(rm.drop_matching(lambda k: k[0] == "structured"))
    rm_counts = (rm.uploads, rm.hits, rm.evictions, rm.bytes_uploaded, rm.peak_bytes,
                 rm.bytes_resident, rm.n_resident, rm.derived_builds, rm.failed_builds)
    store_counts = (store.hits, store.spill_loads, store.misses, store.spilled, len(store))
    return log, rm_counts, store_counts, list(rm._lru)


def test_residency_and_brick_store_counters_match_reference():
    want = _residency_sequence(rc_seqfile, {})
    got = _residency_sequence(seqfile, {"device": "cpu"})
    assert got == want
    assert got[2][3] >= 1 and got[1][2] >= 2     # bricks spilled, entries evicted


def test_residency_failed_build_and_derived_entries_match_reference():
    def run(pkg):
        rm = pkg.ResidencyManager(budget_bytes=1000)
        rm.acquire(("a",), 400, lambda: 1)
        with pytest.raises(RuntimeError):
            rm.acquire(("b",), 700, lambda: (_ for _ in ()).throw(RuntimeError("lost")))
        rm.acquire(("c",), 300, lambda: 2, h2d=False, transient_bytes=200)
        rm.acquire(("c",), 300, lambda: 3)
        return (rm.uploads, rm.hits, rm.evictions, rm.failed_builds, rm.derived_builds,
                rm.derived_bytes, rm.peak_bytes, list(rm._lru), rm.resident(("a",)))
    assert run(seqfile) == run(rc_seqfile)
    with pytest.raises(ValueError):
        seqfile.ResidencyManager(budget_bytes=0)
    with pytest.raises(NotImplementedError):
        seqfile.BrickStore(seqfile.ResidencyManager(), spill=object())


# ----- the fault taxonomy and the materialization tracker ------------------

@pytest.mark.parametrize("exc", [
    "TransientFault", "FatalFault", "DeterminismError", "QueryKilled", "PoisonedChunkError",
    "RuntimeError", "OSError", "TimeoutError", "ValueError", "KeyError",
])
def test_classify_matches_reference(exc):
    def make(mod):
        cls = getattr(mod, exc, None) or getattr(builtins, exc)
        return cls([1, 2]) if exc == "PoisonedChunkError" else cls("x")
    assert faults.classify(make(faults)) == rc_faults.classify(make(rc_faults))


def test_materialize_tracker_retries_escapes_and_skips():
    def drive(pkg, fault_mod):
        slept, done, calls, kill = [], set(), [], [True]
        tracker = pkg.MaterializeTracker(max_attempts=3, backoff_s=0.01, sleep=slept.append)
        tasks = [pkg.BrickTask("r", 0, c) for c in range(4)]

        def run_one(task):
            calls.append(task.col)
            if task.col == 1 and task.attempts == 1:
                raise fault_mod.TransientFault("lost upload")
            if task.col == 2 and kill:
                kill.clear()
                raise fault_mod.QueryKilled("killed")
            done.add(task.col)
            task.status = "done"

        with pytest.raises(fault_mod.QueryKilled):
            tracker.run(tasks, lambda t: t.col in done, run_one)
        rerun = pkg.MaterializeReport(tracker.run(tasks, lambda t: t.col in done, run_one))
        return (slept, calls, tracker.events, [(t.status, t.attempts) for t in tasks],
                rerun.completed, rerun.skipped)

    got = drive(jobtracker, faults)
    assert got == drive(rc_jobtracker, rc_faults)
    slept, calls, events, statuses, completed, skipped = got
    assert slept == [0.01] and calls == [0, 1, 1, 2, 2, 3]
    assert (completed, skipped) == (2, 2)


def test_materialize_bricks_retries_a_transient_fault(surveys, monkeypatch):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu", **LATTICE)
    real = eng.execute
    failed = []

    def flaky(plan):
        if not failed:
            failed.append(plan)
            raise faults.TransientFault("lost upload")
        return real(plan)

    monkeypatch.setattr(eng, "execute", flaky)
    rep = eng.materialize_bricks(region=_region(eng.brick_grid, *WINDOW))
    assert rep.completed == 4 and [t.attempts for t in rep.tasks] == [2, 1, 1, 1]

    def killed(plan):
        raise faults.QueryKilled("killed")

    monkeypatch.setattr(eng, "execute", killed)
    region = _region(eng.brick_grid, 0, 3, 0, 2)      # two more cells, row 0
    with pytest.raises(faults.QueryKilled):
        eng.materialize_bricks(region=region)
    monkeypatch.setattr(eng, "execute", real)
    rep = eng.materialize_bricks(region=region)
    assert (rep.skipped, rep.completed) == (4, 2)


# ----- the CUDA kernel on a card ---------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", MOSAIC_CASES + KERNEL_MOSAIC_CASES)
def test_cuda_mosaic_bitwise_its_plain_version(cuda, name):
    tiles, covs, offsets, npix = _mosaic_case(name)
    args = [torch.from_numpy(a).to(cuda) for a in (tiles, covs, offsets)]
    before = ops.mosaic_bricks.launches
    c, d = ops.mosaic_bricks(*args, npix)
    c_p, d_p = ref.mosaic_bricks_ref(*args, npix)
    torch.cuda.synchronize()
    assert ops.mosaic_bricks.launches == before + 1
    assert torch.equal(c, c_p) and torch.equal(d, d_p)
