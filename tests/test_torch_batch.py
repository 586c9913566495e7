"""Batched queries (paper Fig. 5) in the port, held against the JAX package.

* Plan functions copied from ``repro.core.plan`` (`union_sparse_index`,
  `compact_gates`, `stack_plans`, `grid_digest`, `CoaddPlan.cost_budget`,
  ``coalesce_key`` and ``fingerprint``): bitwise the reference's.
* ``reducer.hist_median`` over the bin axis: bitwise the one-query formula
  on (nbins, Q, Q), query by query on (K, nbins, Q, Q); the elementwise
  between-pass functions broadcast per query, bitwise.
* The batched wrappers (``coadd_fused_batch``, ``coadd_moments_batch``,
  ``coadd_hist_batch``, ``coadd_clip_batch``) on the CPU: each query bitwise
  its one-query wrapper, with and without the slot flag and a PSF bank; the
  batch's pre-pass skips only the slots every query rejects.
* The engine's ``run_batch``/``execute_batch``: each query bitwise its own
  ``run`` for 6 methods x 3 estimators x {unmatched, PSF-matched} x
  ``use_kernel``, and against ``repro``'s ``run_batch`` (its XLA path and
  its Pallas path in interpret mode) at coadd atol 1e-3 / rtol 1e-4, depth
  exactly, counts equal; ``dispatch_count`` grows by one query's passes
  (plus the pre-pass) whatever K is.  Ports of tests/test_engine_scan.py
  (:178, :195), tests/test_sparse_exec.py (:108), tests/test_robust_parity.py
  (:177) and tests/test_psf_parity.py (:85, :230).
* A rejected non-finite slot in a pack only the union brings in: NaNs in
  the batch as in the reference's batch, none in the query's own run, and
  `result_key` keeps the two apart.

The CUDA kernels run only on a card (``gpu`` marker; ``python3
chip_smoke.py`` holds them bitwise against their one-query launches).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
from repro.core import plan as ref_plan
from repro.core import reducer as ref_reducer
from repro_torch.core import plan, reducer
from repro_torch.core.engine import _accept_from_meta
from repro_torch.core.seqfile import PackedDataset
from repro_torch.kernels.warp import ops, ref

ATOL, RTOL = 1e-3, 1e-4          # batch vs the reference's batch (tests/test_engine_scan.py:192)
CFG = dict(n_runs=3, n_fields=5, n_sources=100, height=20, width=20)
SMALL = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
TARGET = 2.5
REDUCES = ("mean", "clipped", "median")
QUERIES = (
    dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=48),
    dict(band="r", ra_bounds=(37.2, 37.7), dec_bounds=(-0.4, 0.2), npix=48),
    dict(band="g", ra_bounds=(37.4, 37.8), dec_bounds=(-0.3, 0.5), npix=48),
)
SMALL_QUERIES = (
    dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32),
    dict(band="r", ra_bounds=(37.3, 37.7), dec_bounds=(-0.4, 0.2), npix=32),
    dict(band="g", ra_bounds=(37.0, 37.5), dec_bounds=(-0.4, 0.2), npix=32),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a):
    return np.ascontiguousarray(a).view(np.int32)


def _bitwise(got, want):
    np.testing.assert_array_equal(_words(got.coadd), _words(want.coadd))
    np.testing.assert_array_equal(_words(got.depth), _words(want.depth))


# ----- plan functions: bitwise the reference's -------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_and_compact_gates_match_reference(seed):
    rng = np.random.default_rng(seed)
    gates = rng.random((4, 40, 8)) < 0.02 * (seed + 1)
    got, want = plan.union_sparse_index(gates), ref_plan.union_sparse_index(gates)
    np.testing.assert_array_equal(got.pack_idx, want.pack_idx)
    assert (got.n_gated, got.budget, got.n_packs, got.worthwhile) == (
        want.n_gated, want.budget, want.n_packs, want.worthwhile)
    np.testing.assert_array_equal(plan.compact_gates(gates, got),
                                  ref_plan.compact_gates(gates, want))
    for g, c in zip(gates, plan.compact_gates(gates, got)):
        # Each query's compacted gate is its own gate over the union's packs.
        np.testing.assert_array_equal(c[:got.n_gated], g[got.pack_idx[:got.n_gated]])


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


@pytest.fixture(scope="module")
def plan_engines(surveys):
    return (rc.CoaddEngine(surveys[0], pack_capacity=16),
            rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu"))


@pytest.mark.parametrize("red", REDUCES)
@pytest.mark.parametrize("method", rt.METHODS)
def test_plan_keys_match_reference(plan_engines, method, red):
    ref_eng, port_eng = plan_engines
    for q in QUERIES:
        want = ref_eng.plan(rc.CoaddQuery(**q), method, reduce=red)
        got = port_eng.plan(rt.CoaddQuery(**q), method, reduce=red)
        assert got.cost_budget == want.cost_budget
        assert got.coalesce_key == want.coalesce_key
        assert got.fingerprint == want.fingerprint


def test_grid_digest_and_brick_plan_keys_match_reference(plan_engines):
    ref_eng, port_eng = plan_engines
    assert plan.grid_digest(None) == ref_plan.grid_digest(None) == ""
    want = ref_eng._brick_plan("r", 1, 2, "sql_structured")
    got = port_eng._brick_plan("r", 1, 2, "sql_structured")
    assert plan.grid_digest(got.grid_sky) == ref_plan.grid_digest(want.grid_sky) != ""
    assert got.coalesce_key == want.coalesce_key and got.fingerprint == want.fingerprint
    # A lattice plan never coalesces with the query-grid plan of its box.
    plain = port_eng.plan(got.query, "sql_structured")
    assert plain.coalesce_key != got.coalesce_key


def test_stack_plans_matches_reference_and_rejects_mixed(plan_engines):
    ref_eng, port_eng = plan_engines
    got = plan.stack_plans([port_eng.plan(rt.CoaddQuery(**q), "sql_structured")
                            for q in QUERIES])
    want = ref_plan.stack_plans([ref_eng.plan(rc.CoaddQuery(**q), "sql_structured")
                                 for q in QUERIES])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a = port_eng.plan(rt.CoaddQuery(**QUERIES[0]), "sql_structured")
    mixed = {
        "layout": port_eng.plan(rt.CoaddQuery(**QUERIES[0]), "raw_fits"),
        "npix": port_eng.plan(rt.CoaddQuery(**dict(QUERIES[0], npix=32)), "sql_structured"),
        "reduce": port_eng.plan(rt.CoaddQuery(**QUERIES[0]), "sql_structured", "median"),
    }
    for what, b in mixed.items():
        with pytest.raises(ValueError, match=f"share a {what}|share {what}"):
            plan.stack_plans([a, b])
        with pytest.raises(ValueError):
            port_eng.execute_batch([a, b])
    with pytest.raises(ValueError, match="zero plans"):
        plan.stack_plans([])


# ----- reducer: the median over the bin axis --------------------------------

def _hist_stack(seed, k=3, nbins=16, q=9):
    rng = np.random.default_rng(seed)
    hist = torch.from_numpy(rng.integers(0, 4, (k, nbins, q, q)).astype(np.float32))
    hist[:, :, 0, 0] = 0.0                                # an empty pixel
    s0 = hist.sum(1)
    lo = torch.from_numpy(rng.normal(size=(k, q, q)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.0, 0.5, (k, q, q)).astype(np.float32))
    return hist, s0, lo, w


@pytest.mark.parametrize("seed", [0, 1])
def test_hist_median_over_the_bin_axis(seed):
    hist, s0, lo, w = _hist_stack(seed)
    batched = reducer.hist_median(hist, s0, lo, w)
    assert batched.shape == s0.shape
    for k in range(hist.shape[0]):
        one = reducer.hist_median(hist[k], s0[k], lo[k], w[k])
        # The one-query formula before the bins moved to dim -3, bitwise.
        c = torch.cumsum(hist[k], dim=0)
        j = (c >= 0.5 * s0[k][None]).to(torch.uint8).argmax(dim=0).to(hist.dtype)
        old = lo[k] + (j + 0.5) * w[k]
        assert torch.equal(one.view(torch.int32), old.view(torch.int32))
        assert torch.equal(batched[k].view(torch.int32), one.view(torch.int32))
        want = np.asarray(ref_reducer.hist_median(*(jnp.asarray(t[k].numpy())
                                                    for t in (hist, s0, lo, w))))
        np.testing.assert_array_equal(_words(one.numpy()), _words(want))


def test_between_pass_arithmetic_broadcasts_per_query():
    rng = np.random.default_rng(4)
    s0 = torch.from_numpy(rng.integers(0, 6, (3, 7, 7)).astype(np.float32))
    s1 = torch.from_numpy(rng.normal(10.0, 3.0, (3, 7, 7)).astype(np.float32)) * s0
    s2 = s1 * s1 / s0.clamp(min=1.0) + torch.from_numpy(
        rng.uniform(0.0, 5.0, (3, 7, 7)).astype(np.float32))
    mu, sigma = reducer.clip_stats(s0, s1, s2)
    thresh = reducer.clip_threshold(mu, sigma, 3.0)
    bounds = reducer.hist_bounds(s0, s1, s2, 16)
    for k in range(3):
        mu1, sigma1 = reducer.clip_stats(s0[k], s1[k], s2[k])
        got = (mu[k], sigma[k], thresh[k]) + tuple(b[k] for b in bounds)
        want = ((mu1, sigma1, reducer.clip_threshold(mu1, sigma1, 3.0))
                + reducer.hist_bounds(s0[k], s1[k], s2[k], 16))
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_accept_broadcasts_a_query_axis(plan_engines):
    port_eng = plan_engines[1]
    plans = [port_eng.plan(rt.CoaddQuery(**q), "sql_structured") for q in QUERIES]
    dev = port_eng.device_dataset("structured")
    qvecs = torch.from_numpy(np.stack([p.qvec for p in plans]))
    got = _accept_from_meta(dev.ints, dev.floats, qvecs)
    assert got.shape == (3,) + tuple(dev.ints["band_id"].shape)
    for k in range(3):
        assert torch.equal(got[k], _accept_from_meta(dev.ints, dev.floats, qvecs[k]))
    assert got.any(dim=(1, 2)).all()


# ----- the batched wrappers on the CPU ---------------------------------------

@pytest.fixture(scope="module")
def scan_batch():
    """A small layout (one pack of 8 and one of 4 frames through
    `pack_structured`), 3 queries' accepts and grids."""
    eng = rt.CoaddEngine(rt.make_survey(rt.SurveyConfig(**SMALL)), pack_capacity=8,
                         device="cpu", match_psf_sigma=TARGET)
    plans = [eng.plan(rt.CoaddQuery(**q), "sql_structured") for q in SMALL_QUERIES]
    gates = np.stack([eng._exec_gate(p) for p in plans])
    dev, idx, accept = eng._operands("structured", gates, np.stack([p.qvec for p in plans]))
    grids = [eng._plan_grids(p) for p in plans]
    banks = {"sep": None, "2d": eng._device_psf_kernels("structured")}
    eng.measured_psf = False
    banks["sep"] = eng._device_psf_kernels("structured")
    return (dev, idx, accept.to(torch.float32), torch.stack([g[0] for g in grids]),
            torch.stack([g[1] for g in grids]), banks)


def _passes(fns, scan, k=None, **kw):
    """Every pass (fused, moments, hist at 8/16/32, clip) through ``fns``, on
    fixed operands from the one-query moments of the (batched) scan."""
    fused, moments, hist, clip = fns
    s = moments(*scan, **kw)
    out = list(fused(*scan, **kw)) + list(s)
    mu, sigma = reducer.clip_stats(*s)
    for nbins in ops.HIST_BINS:
        lo, _, inv_w = reducer.hist_bounds(*s, nbins)
        out.append(hist(*scan, lo, inv_w, nbins, **kw))
    out += list(clip(*scan, mu, reducer.clip_threshold(mu, sigma, 3.0), **kw))
    return out


SINGLE = (ops.coadd_fused, ops.coadd_moments, ops.coadd_hist, ops.coadd_clip)
BATCH = (ops.coadd_fused_batch, ops.coadd_moments_batch, ops.coadd_hist_batch,
         ops.coadd_clip_batch)


@pytest.mark.parametrize("bank", [None, "sep", "2d"])
@pytest.mark.parametrize("flagged", [False, True], ids=["no_flag", "flag"])
def test_batch_wrappers_are_each_query_bitwise(scan_batch, bank, flagged):
    dev, idx, accept, gr, gd, banks = scan_batch
    kw = dict(finite=dev.finite if flagged else None)
    if bank is not None:
        kw["psf_kernels"] = banks[bank]
    got = _passes(BATCH, (dev.pixels, dev.wcs, idx, accept, gr, gd), **kw)
    assert got[0].shape == gr.shape and got[5].shape == (3, 8) + tuple(gr.shape[1:])
    assert float(got[1].sum()) > 0
    for k in range(accept.shape[0]):
        want = _passes(SINGLE, (dev.pixels, dev.wcs, idx, accept[k], gr[k], gd[k]), **kw)
        for a, b in zip(got, want):
            assert torch.equal(a[k].view(torch.int32), b.view(torch.int32))


def test_batch_refs_are_the_one_query_refs(scan_batch):
    dev, idx, accept, gr, gd, _ = scan_batch
    scan = (dev.pixels, dev.wcs, idx, accept, gr, gd)
    fixed = (torch.full(gr.shape, 100.0), torch.full(gr.shape, 0.5))
    got = (ref.coadd_scan_batch_ref(*scan) + ref.moments_scan_batch_ref(*scan)
           + (ref.hist_scan_batch_ref(*scan, *fixed, 8),)
           + ref.clip_scan_batch_ref(*scan, *fixed))
    for k in range(3):
        one = (dev.pixels, dev.wcs, idx, accept[k], gr[k], gd[k])
        f1 = tuple(f[k] for f in fixed)
        want = (ref.coadd_scan_ref(*one) + ref.moments_scan_ref(*one)
                + (ref.hist_scan_ref(*one, *f1, 8),) + ref.clip_scan_ref(*one, *f1))
        for a, b in zip(got, want):
            assert torch.equal(a[k], b)


def test_batch_prepass_skips_only_what_every_query_rejects(scan_batch, monkeypatch):
    """One pre-pass for the batch: a slot that any query accepts is matched
    (a skip from one query's accept would write zeros another query reads),
    and every pass over the gated scratch is bitwise the ungated one."""
    dev, idx, accept, gr, gd, banks = scan_batch
    bank = banks["2d"]
    flag = ops.matched_finite(dev.finite, idx, bank)
    skip = ops.prepass_skip(accept, flag)
    only_one = ((accept != 0).sum(0) == 1) & (flag != 0)
    assert bool(only_one.any()) and not bool(skip[only_one].any())
    assert torch.equal(skip, ((accept == 0).all(0) & (flag != 0)).to(torch.uint8))
    assert int(skip.sum()) > 0
    for k in range(3):                       # one query's own skip would zero them
        assert bool(ops.prepass_skip(accept[k], flag)[only_one].any())
    skips = []
    real = ops.psf_match

    def spy(pixels, pack_idx, psf_kernels, skip=None, ungate=False, **kw):
        skips.append(skip)
        return real(pixels, pack_idx, psf_kernels, None if ungate else skip, **kw)

    monkeypatch.setattr(ops, "psf_match", spy)
    scan = (dev.pixels, dev.wcs, idx, accept, gr, gd)
    gated = _passes(BATCH, scan, psf_kernels=bank, finite=dev.finite)
    assert len(skips) == 6 and all(torch.equal(s, skip) for s in skips)
    monkeypatch.setattr(ops, "psf_match", lambda pixels, pack_idx, bank, skip=None, **kw: spy(
        pixels, pack_idx, bank, skip, ungate=True, **kw))
    ungated = _passes(BATCH, scan, psf_kernels=bank, finite=dev.finite)
    for a, b in zip(gated, ungated):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


BAD = {
    "accept_2d": (3, lambda a: a[0], "accept must have 3 dims"),
    "grid_k": (4, lambda g: g[:2], r"grids must both be \(K, Q, Q\)"),
    "grid_2d": (4, lambda g: g[0], "grid_ra must have 3 dims"),
    "fixed_2d": ("fixed", lambda f: f[0], "must have 3 dims"),
    "fixed_k": ("fixed", lambda f: f[:1], r"must be \(3,"),
    "accept_g": (3, lambda a: a[:, :1], "do not match"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_batch_wrappers_reject_bad_operands(scan_batch, name):
    dev, idx, accept, gr, gd, _ = scan_batch
    at, bad, err = BAD[name]
    args = [dev.pixels, dev.wcs, idx, accept, gr, gd]
    center, thresh = torch.zeros(gr.shape), torch.ones(gr.shape)
    if at == "fixed":
        center = bad(center)
    else:
        args[at] = bad(args[at]).contiguous()
    with pytest.raises(ValueError, match=err):
        ops.coadd_clip_batch(*args, center, thresh)


def test_cpu_batch_calls_do_not_count_launches(scan_batch):
    dev, idx, accept, gr, gd, _ = scan_batch
    before = [f.launches for f in BATCH]
    _passes(BATCH, (dev.pixels, dev.wcs, idx, accept, gr, gd), finite=dev.finite)
    assert [f.launches for f in BATCH] == before == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="nbins"):
        ops.coadd_hist_batch(dev.pixels, dev.wcs, idx, accept, gr, gd, gr, gr, 12)


# ----- the engine: each query bitwise its own run ---------------------------

@pytest.fixture(scope="module")
def small_engines():
    sv = rt.make_survey(rt.SurveyConfig(**SMALL))
    cache = {}

    def get(use_kernel, target):
        if (use_kernel, target) not in cache:
            cache[use_kernel, target] = rt.CoaddEngine(sv, pack_capacity=8, device="cpu",
                                                       use_kernel=use_kernel,
                                                       match_psf_sigma=target)
        return cache[use_kernel, target]

    return get


@pytest.mark.parametrize("target", [None, TARGET], ids=["unmatched", "psf"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("red", REDUCES)
@pytest.mark.parametrize("method", rt.METHODS)
def test_run_batch_is_bitwise_each_run(small_engines, method, red, use_kernel, target):
    eng = small_engines(use_kernel, target)
    queries = [rt.CoaddQuery(**q) for q in SMALL_QUERIES]
    singles = [eng.run(q, method, reduce=red) for q in queries]
    before = eng.dispatch_count
    batch = eng.run_batch(queries, method, reduce=red)
    passes = REDUCES.index(red) + 1
    assert eng.dispatch_count - before == passes + (use_kernel and target is not None)
    assert len(batch) == 3 and max(float(r.depth.max()) for r in batch) >= 2
    for b, s, q in zip(batch, singles, queries):
        _bitwise(b, s)
        assert b.stats.batch_scan == ""
        assert b.stats.reduce == red and b.stats.reduce_passes == passes
        for f in ("files_considered", "files_contributing", "packs_touched", "packs_gated"):
            assert getattr(b.stats, f) == getattr(s.stats, f), f
        p = eng.plan(q, method, red)
        assert eng.result_key(p, b) == eng.result_key(p)
    s0 = batch[0].stats
    assert s0.dispatches == (passes + (target is not None) if use_kernel
                             else passes * s0.packs_scanned)
    assert all(r.stats.dispatches == r.stats.packs_scanned == 0 for r in batch[1:])
    assert all(r.stats.t_map_reduce_s == 0.0 for r in batch[1:])
    assert all(r.stats.scan_budget == s0.packs_scanned for r in batch)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("red", REDUCES)
def test_dispatches_per_batch_whatever_k(small_engines, red, k):
    eng = small_engines(True, TARGET)
    queries = [rt.CoaddQuery(**dict(SMALL_QUERIES[i % 3], ra_bounds=(37.1 + 0.05 * i, 37.6)))
               for i in range(k)]
    before = eng.dispatch_count
    res = eng.run_batch(queries, "sql_structured", reduce=red)
    assert eng.dispatch_count - before == REDUCES.index(red) + 2
    assert sum(r.stats.dispatches for r in res) == REDUCES.index(red) + 2


# ----- the engine against the reference's run_batch --------------------------

@pytest.fixture(scope="module")
def engine_pairs(surveys):
    cache = {}

    def get(use_kernel, sparse=True, **kw):
        key = (use_kernel, sparse, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = (
                rc.CoaddEngine(surveys[0], pack_capacity=16, use_kernel=use_kernel,
                               sparse=sparse, **kw),
                rt.CoaddEngine(surveys[1], pack_capacity=16, use_kernel=use_kernel,
                               sparse=sparse, device="cpu", **kw),
            )
        return cache[key]

    return get


def _hold_batch(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.coadd.dtype == g.depth.dtype == np.float32
        np.testing.assert_array_equal(g.depth, w.depth)
        np.testing.assert_allclose(g.coadd, w.coadd, atol=ATOL, rtol=RTOL)
        assert (g.stats.files_considered, g.stats.files_contributing, g.stats.packs_gated) == (
            w.stats.files_considered, w.stats.files_contributing, w.stats.packs_gated)
        assert g.stats.scan_budget == w.stats.scan_budget


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("method", rt.METHODS)
def test_run_batch_matches_reference(engine_pairs, method, use_kernel, sparse):
    """tests/test_engine_scan.py:178 and tests/test_sparse_exec.py:108 on the
    port: the batch against the reference's batch, and each query bitwise
    the port's own run."""
    ref_eng, port_eng = engine_pairs(use_kernel, sparse)
    want = ref_eng.run_batch([rc.CoaddQuery(**q) for q in QUERIES], method)
    queries = [rt.CoaddQuery(**q) for q in QUERIES]
    before = port_eng.dispatch_count
    got = port_eng.run_batch(queries, method)
    assert port_eng.dispatch_count - before == 1
    assert min(float(r.depth.max()) for r in got) > 0
    _hold_batch(got, want)
    for g, q in zip(got, queries):
        _bitwise(g, port_eng.run(q, method))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("red", ("clipped", "median"))
def test_robust_run_batch_matches_reference(engine_pairs, red, use_kernel):
    """tests/test_robust_parity.py:177 on the port: the estimator rides
    through the batch; against the reference's batch, depth exactly."""
    ref_eng, port_eng = engine_pairs(use_kernel)
    queries = [QUERIES[0], dict(QUERIES[0], band="r"), QUERIES[1]]
    want = ref_eng.run_batch([rc.CoaddQuery(**q) for q in queries], "sql_structured",
                             reduce=red)
    got = port_eng.run_batch([rt.CoaddQuery(**q) for q in queries], "sql_structured",
                             reduce=red)
    assert all(r.stats.reduce == red for r in got)
    _hold_batch(got, want)
    _bitwise(got[0], got[1])


@pytest.mark.parametrize("red", REDUCES)
@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
def test_psf_run_batch_matches_reference(engine_pairs, use_kernel, red):
    ref_eng, port_eng = engine_pairs(use_kernel, match_psf_sigma=TARGET)
    want = ref_eng.run_batch([rc.CoaddQuery(**q) for q in QUERIES], "raw_fits_prefiltered",
                             reduce=red)
    got = port_eng.run_batch([rt.CoaddQuery(**q) for q in QUERIES], "raw_fits_prefiltered",
                             reduce=red)
    _hold_batch(got, want)


def test_run_batch_one_pass_no_reupload(surveys, monkeypatch):
    """tests/test_engine_scan.py:195 on the port: K queries are one pass and
    no pack is uploaded again."""
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    eng.run(rt.CoaddQuery(**QUERIES[0]), "sql_structured")
    uploads = eng.pack_upload_count

    def _no_more_uploads(self, *args):
        raise AssertionError("pack pixels re-uploaded by run_batch")

    monkeypatch.setattr(PackedDataset, "to_device", _no_more_uploads)
    queries = [rt.CoaddQuery(band="r", ra_bounds=(37.2 + 0.1 * i, 37.8 + 0.1 * i),
                             dec_bounds=(-0.5, 0.3), npix=48) for i in range(3)]
    before = eng.dispatch_count
    results = eng.run_batch(queries, "sql_structured")
    assert eng.dispatch_count - before == 1
    assert eng.pack_upload_count == uploads
    assert sum(r.stats.dispatches for r in results) == 1
    assert eng.run_batch([], "sql_structured") == []


def test_psf_batch_measured_matches_fallback():
    """tests/test_psf_parity.py:85 on the port: on Gaussian stamps the
    measured bank's batch agrees with the fallback's."""
    sv = rt.make_survey(rt.SurveyConfig(**SMALL, moffat_beta=None, psf_ellip_jitter=0.0,
                                        psf_stamp_size=17))
    queries = [rt.CoaddQuery(**SMALL_QUERIES[0]),
               rt.CoaddQuery(band="r", ra_bounds=(37.1, 37.6), dec_bounds=(-0.4, 0.4), npix=32)]
    kw = dict(pack_capacity=16, match_psf_sigma=2.0, device="cpu")
    res_m = rt.CoaddEngine(sv, **kw).run_batch(queries, "sql_structured")
    res_g = rt.CoaddEngine(sv, measured_psf=False, **kw).run_batch(queries, "sql_structured")
    for rm, rg in zip(res_m, res_g):
        np.testing.assert_array_equal(rm.depth, rg.depth)
        scale = max(float(np.abs(rg.coadd).max()), 1.0)
        assert np.abs(rm.coadd - rg.coadd).max() / scale < 2e-3


def test_stale_plan_psf_target_rejected_by_execute_batch(surveys):
    """tests/test_psf_parity.py:230 on the port."""
    eng_a = rt.CoaddEngine(surveys[1], pack_capacity=16, match_psf_sigma=2.0, device="cpu")
    eng_b = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    p = eng_a.plan(rt.CoaddQuery(**QUERIES[0]), "sql_structured")
    with pytest.raises(ValueError, match="psf_target"):
        eng_b.execute(p)
    with pytest.raises(ValueError, match="psf_target"):
        eng_b.execute_batch([p])


def test_reblocked_per_file_batch_remaps_each_gate(surveys):
    """raw_fits_prefiltered plans the per-file layout; the batch rewrites
    every query's gate onto the reblocked super-packs."""
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    queries = [rt.CoaddQuery(**q) for q in QUERIES]
    got = eng.run_batch(queries, "raw_fits_prefiltered")
    assert eng.exec_dataset("per_file")[1] is not None
    for g, q in zip(got, queries):
        _bitwise(g, eng.run(q, "raw_fits_prefiltered"))


# ----- a rejected NaN that only the union brings in -------------------------

POISON_QUERY = dict(ra_bounds=(37.3, 37.7), dec_bounds=(-0.3, 0.3), npix=32)


def poisoned_surveys():
    """Both packages' SMALL survey with one g-band frame that covers the
    middle of POISON_QUERY holding a NaN, an inf and 2**70 (the three
    plants of test_torch_cull.py's ``_poisoned``) in its centre rows."""
    svs = rc.make_survey(rc.SurveyConfig(**SMALL)), rt.make_survey(rt.SurveyConfig(**SMALL))
    mid_ra, mid_dec = 37.55, 0.1
    for sv in svs:
        hits = [i for i, im in enumerate(sv.images) if im.band == "g"
                and im.bounds[0] < mid_ra < im.bounds[1]
                and im.bounds[2] < mid_dec < im.bounds[3]]
        img = sv.images[hits[0]]
        h, w = img.pixels.shape
        img.pixels[h // 2, w // 2 - 3:w // 2 + 3:2] = [np.nan, np.inf, np.float32(2.0 ** 70)]
    return svs


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_union_brings_a_rejected_nan_as_the_reference_does(use_kernel):
    ref_sv, port_sv = poisoned_surveys()
    port = rt.CoaddEngine(port_sv, pack_capacity=8, device="cpu", use_kernel=use_kernel)
    ref_eng = rc.CoaddEngine(ref_sv, pack_capacity=8)
    queries = [dict(POISON_QUERY, band="r"), dict(POISON_QUERY, band="g")]
    got = port.run_batch([rt.CoaddQuery(**q) for q in queries], "sql_structured")
    want = ref_eng.run_batch([rc.CoaddQuery(**q) for q in queries], "sql_structured")
    alone = port.run(rt.CoaddQuery(**queries[0]), "sql_structured")
    assert port.exec_dataset("structured")[0].n_packs > got[0].stats.scan_budget
    # The r query rejects the poisoned g frame; only the union scans its pack.
    assert np.isfinite(alone.coadd).all() and np.isnan(got[0].coadd).any()
    np.testing.assert_array_equal(np.isnan(got[0].coadd), np.isnan(want[0].coadd))
    ok = ~np.isnan(got[0].coadd)
    np.testing.assert_allclose(got[0].coadd[ok], want[0].coadd[ok], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[0].depth, want[0].depth)
    np.testing.assert_array_equal(got[0].coadd[ok], alone.coadd[ok])
    # The g query accepts it, alone and batched: its NaNs are its own.
    _bitwise(got[1], port.run(rt.CoaddQuery(**queries[1]), "sql_structured"))
    # The key keeps the r result off its own run's key; the g result keeps it.
    plans = [port.plan(rt.CoaddQuery(**q), "sql_structured") for q in queries]
    assert got[0].stats.batch_scan != "" and got[1].stats.batch_scan == ""
    assert port.result_key(plans[0], got[0]) != port.result_key(plans[0])
    assert port.result_key(plans[1], got[1]) == port.result_key(plans[1])


def test_result_key_tracks_engine_state(surveys):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    q = rt.CoaddQuery(**QUERIES[0])
    p = eng.plan(q, "sql_structured")
    base = eng.result_key(p)
    # The method is job-init cost, not pixels: it is not in the key.
    assert eng.result_key(dataclasses.replace(p, method="structured_seq_prefiltered")) == base
    assert eng.result_key(eng.plan(q, "sql_structured", "clipped")) != base
    eng.match_psf_sigma = 2.0
    assert eng.result_key(eng.plan(q, "sql_structured")) != base
    eng.match_psf_sigma = None
    eng.use_kernel = False
    assert eng.result_key(eng.plan(q, "sql_structured")) != base


# ----- the query-axis kernel on a card ---------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("flagged", [False, True], ids=["no_flag", "flag"])
def test_cuda_batch_is_each_query_bitwise(cuda, scan_batch, flagged):
    dev, idx, accept, gr, gd, _ = scan_batch
    scan = tuple(t.to(cuda) for t in (dev.pixels, dev.wcs, idx, accept, gr, gd))
    fin = dev.finite.to(cuda) if flagged else None
    got = _passes(BATCH, scan, finite=fin)
    for k in range(3):
        want = _passes(SINGLE, scan[:3] + (scan[3][k], scan[4][k], scan[5][k]), finite=fin)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a[k].view(torch.int32), b.view(torch.int32))
