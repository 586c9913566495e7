"""The port's engine, end to end, held against the JAX package's engine.

The same survey goes through ``repro`` and ``repro_torch`` for all six
methods, dense and sparse, with the reference's XLA path and its Pallas
path (interpret mode): coadd at atol 2e-2 / rtol 1e-4 (the reference's
kernel-vs-oracle tolerance, tests/test_kernels.py:30), depth exactly except
within 1e-3 px of an image edge, and the job's counts equal.  The rest ports
the reference's own engine tests (tests/test_coadd_engine.py,
tests/test_sparse_exec.py, tests/test_system.py) onto the port.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
from repro_torch.core.engine import _query_vec
from repro_torch.core.plan import CoaddPlan, scan_budget
from repro_torch.core.seqfile import PackedDataset
from repro_torch.kernels.warp import ops, ref

ATOL, RTOL = 2e-2, 1e-4
CFG = dict(n_runs=3, n_fields=5, n_sources=100, height=20, width=20)
QUERY = dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=48)
QUERY_T = dict(QUERY, npix=40, time_bounds=(100.0, 299.0))
QUERY2 = dict(band="r", ra_bounds=(37.4, 37.8), dec_bounds=(-0.4, 0.2), npix=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores (2.5x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


@pytest.fixture(scope="module")
def engine_pairs(surveys):
    ref_sv, port_sv = surveys
    cache = {}

    def get(use_kernel, sparse):
        key = (use_kernel, sparse)
        if key not in cache:
            cache[key] = (
                rc.CoaddEngine(ref_sv, pack_capacity=16, use_kernel=use_kernel, sparse=sparse),
                rt.CoaddEngine(port_sv, pack_capacity=16, use_kernel=use_kernel,
                               sparse=sparse, device="cpu"),
            )
        return cache[key]

    return get


@pytest.fixture(scope="module")
def engine(surveys):
    return rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")


def _hold_against(port_eng, plan, got, want):
    """Coadd at the kernel tolerance and depth exactly, off the image edges."""
    dev, idx, accept = port_eng._scan_operands(plan)
    gr, gd = port_eng._grids(plan.query)
    h, w = dev.pixels.shape[-2:]
    near, far = ref.coverage_flips(torch.tensor(got.depth), torch.tensor(want.depth),
                                   h, w, dev.wcs[idx.long()].reshape(-1, 8),
                                   accept.reshape(-1).float(), gr, gd)
    assert not far.any(), f"{int(far.sum())} depth pixels differ away from the edges"
    keep = ~near.numpy()
    np.testing.assert_allclose(got.coadd[keep], want.coadd[keep], atol=ATOL, rtol=RTOL)
    assert np.isfinite(got.coadd).all()


@pytest.mark.parametrize("query", [QUERY, QUERY_T], ids=["box", "time_window"])
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("method", rt.METHODS)
def test_engine_matches_reference(engine_pairs, method, use_kernel, sparse, query):
    ref_eng, port_eng = engine_pairs(use_kernel, sparse)
    want = ref_eng.run(rc.CoaddQuery(**query), method)
    plan = port_eng.plan(rt.CoaddQuery(**query), method)
    got = port_eng.execute(plan)
    assert want.depth.max() > 0
    assert got.coadd.shape == got.depth.shape == want.coadd.shape
    assert got.coadd.dtype == got.depth.dtype == np.float32
    _hold_against(port_eng, plan, got, want)
    g, w = got.stats, want.stats
    assert (g.files_considered, g.files_contributing) == (w.files_considered, w.files_contributing)
    assert (g.packs_touched, g.packs_gated) == (w.packs_touched, w.packs_gated)
    assert g.packs_scanned == g.scan_budget == w.packs_scanned == w.scan_budget
    np.testing.assert_allclose(got.normalized[got.depth > 0], want.normalized[got.depth > 0],
                               atol=ATOL, rtol=RTOL)


def test_one_fused_call_per_query(engine, monkeypatch):
    """Each query is one pass: one coadd_fused call, whatever the pack count."""
    calls = []
    real = ops.coadd_fused

    def counting(*args, **kw):
        calls.append(args[2].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "coadd_fused", counting)
    for m in rt.METHODS:
        before = engine.dispatch_count
        r = engine.run(rt.CoaddQuery(**QUERY), m)
        assert engine.dispatch_count - before == 1 and r.stats.dispatches == 1
    assert len(calls) == len(rt.METHODS) and max(calls) > 1


# ----- the reference's engine tests, on the port ---------------------------

def test_all_methods_agree(engine):
    results = {m: engine.run(rt.CoaddQuery(**QUERY), m) for m in rt.METHODS}
    base = results["sql_structured"]
    assert base.depth.max() > 0
    for r in results.values():
        np.testing.assert_allclose(r.coadd, base.coadd, atol=1e-3)
        np.testing.assert_array_equal(r.depth, base.depth)


def test_depth_bounded_by_runs(engine, surveys):
    r = engine.run(rt.CoaddQuery(**QUERY), "sql_structured")
    assert r.depth.max() <= surveys[1].config.n_runs


def test_table2_structure(engine, surveys):
    """Mapper-input-record orderings from the paper's Table 2."""
    stats = {m: engine.run(rt.CoaddQuery(**QUERY), m).stats for m in rt.METHODS}
    coverage = stats["sql_structured"].files_contributing
    assert stats["sql_structured"].files_considered == coverage
    assert stats["sql_unstructured"].files_considered == coverage
    assert stats["raw_fits_prefiltered"].files_considered >= coverage
    assert stats["structured_seq_prefiltered"].files_considered >= coverage
    assert stats["structured_seq_prefiltered"].files_considered \
        < stats["unstructured_seq"].files_considered == len(surveys[1])
    assert stats["sql_structured"].packs_touched <= stats["sql_unstructured"].packs_touched


def test_all_contributors_found(engine, surveys):
    exact = len(rt.SpatialIndex.build(surveys[1]).select(rt.CoaddQuery(**QUERY)))
    for m in rt.METHODS:
        assert engine.run(rt.CoaddQuery(**QUERY), m).stats.files_contributing == exact


def test_time_bounds_query(engine):
    q_t = rt.CoaddQuery(**dict(QUERY, time_bounds=(0.0, 99.0)))   # first run only
    r_all = engine.run(rt.CoaddQuery(**QUERY), "sql_structured")
    r_t = engine.run(q_t, "sql_structured")
    assert r_t.stats.files_contributing < r_all.stats.files_contributing
    assert r_t.depth.max() <= 1


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_wrapper"])
@pytest.mark.parametrize("method", rt.METHODS)
def test_sparse_matches_dense(surveys, method, use_kernel):
    mk = lambda sparse: rt.CoaddEngine(surveys[1], pack_capacity=8, use_kernel=use_kernel,  # noqa: E731
                                       sparse=sparse, device="cpu")
    eng_s, eng_d = mk(True), mk(False)
    rs = eng_s.run(rt.CoaddQuery(**QUERY2), method)
    rd = eng_d.run(rt.CoaddQuery(**QUERY2), method)
    assert rd.depth.max() > 0
    np.testing.assert_allclose(rs.coadd, rd.coadd, atol=5e-2, rtol=1e-3)
    np.testing.assert_array_equal(rs.depth, rd.depth)
    assert rs.stats.files_considered == rd.stats.files_considered
    assert rs.stats.files_contributing == rd.stats.files_contributing
    assert rs.stats.packs_scanned <= rd.stats.packs_scanned
    assert rs.stats.packs_gated <= rs.stats.packs_scanned == rs.stats.scan_budget


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel_wrapper"])
def test_empty_gate_zero_coadd_no_nans(surveys, use_kernel):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, use_kernel=use_kernel, device="cpu")
    far = rt.CoaddQuery(band="r", ra_bounds=(200.0, 201.0), dec_bounds=(50.0, 51.0), npix=32)
    before = eng.dispatch_count
    r = eng.run(far, "sql_structured")
    assert eng.dispatch_count - before == 1
    assert np.all(r.coadd == 0) and np.all(r.depth == 0)
    assert not np.isnan(r.normalized).any()
    assert r.stats.files_considered == 0 and r.stats.files_contributing == 0
    assert r.stats.packs_gated == 0 and r.stats.scan_budget == 1


def test_budget_bucket_boundary_through_engine(surveys):
    """Gates straddling a bucket edge (4 vs 5 gated) both execute correctly."""
    eng_s = rt.CoaddEngine(surveys[1], pack_capacity=8, sparse=True, device="cpu")
    eng_d = rt.CoaddEngine(surveys[1], pack_capacity=8, sparse=False, device="cpu")
    q = rt.CoaddQuery(**QUERY2)
    ds = eng_s.dataset("structured")
    for n_packs_gated in (4, 5):
        gate = np.zeros_like(ds.valid)
        gate[:n_packs_gated] = ds.valid[:n_packs_gated]
        plan = CoaddPlan("sql_structured", "structured", gate, _query_vec(q), q, 0.0)
        rs, rd = eng_s.execute(plan), eng_d.execute(plan)
        np.testing.assert_allclose(rs.coadd, rd.coadd, atol=5e-2, rtol=1e-3)
        np.testing.assert_array_equal(rs.depth, rd.depth)
        assert rs.stats.scan_budget == scan_budget(n_packs_gated, ds.n_packs)
        assert rs.stats.packs_gated == n_packs_gated


def test_reblocked_per_file_scans_super_packs(surveys):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    ds = eng.dataset("per_file")
    rb, remap = eng.exec_dataset("per_file")
    assert ds.capacity == 1 and rb.capacity == 8
    assert rb.n_packs == int(np.ceil(ds.n_images / 8)) and rb.n_images == ds.n_images
    for img_id in list(ds.index)[:20]:
        p, s = ds.index[img_id]
        np.testing.assert_array_equal(rb.pixels[remap.rb_pack[p, s], remap.rb_slot[p, s]],
                                      ds.pixels[p, s])
    r = eng.run(rt.CoaddQuery(**QUERY), "raw_fits")
    assert r.stats.packs_scanned <= rb.n_packs


def test_no_reupload_across_queries(surveys, monkeypatch):
    eng = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    eng.run(rt.CoaddQuery(**QUERY), "raw_fits_prefiltered")
    uploads = eng.pack_upload_count

    def _boom(self, *args):
        raise AssertionError("pack pixels re-uploaded on a repeat query")

    monkeypatch.setattr(PackedDataset, "to_device", _boom)
    monkeypatch.setattr(PackedDataset, "reblock", _boom)
    eng.run(rt.CoaddQuery(**QUERY2), "raw_fits_prefiltered")
    eng.run(rt.CoaddQuery(**QUERY2), "raw_fits")
    assert eng.pack_upload_count == uploads == 1
    assert eng.resident_bytes == eng.device_dataset("per_file").nbytes


def test_end_to_end_stacking_improves_snr():
    """The paper's Fig. 2 effect: the stack has higher SNR than one exposure."""
    cfg = rt.SurveyConfig(n_runs=6, n_fields=4, n_sources=80, height=24, width=24,
                          noise_sigma=8.0)
    sv = rt.make_survey(cfg)
    eng = rt.CoaddEngine(sv, pack_capacity=32, device="cpu")
    q = rt.CoaddQuery(band="r", ra_bounds=(37.2, 37.7), dec_bounds=(-0.5, 0.2), npix=64)
    res = eng.run(q, "sql_structured")
    deep = res.depth >= cfg.n_runs - 1
    assert deep.sum() > 200, "query should be well-covered"
    q1 = rt.CoaddQuery(band="r", ra_bounds=q.ra_bounds, dec_bounds=q.dec_bounds,
                       npix=64, time_bounds=(0.0, 99.0))
    res1 = eng.run(q1, "sql_structured")
    m_all, m_one = res.normalized, res1.normalized
    sky = np.median(m_all[deep])
    bg = deep & (m_all < sky + 2)
    assert bg.sum() > 50
    noise_stack = np.std(m_all[bg])
    noise_one = np.std(m_one[bg & (res1.depth > 0)])
    assert noise_stack < noise_one * 0.75, (noise_stack, noise_one)
