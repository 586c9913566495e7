"""Multi-device coadd jobs in the port (DESIGN.md §4), world 1 and units,
held against the JAX package.

The host halves of mesh residency bitwise the reference's:
`shard_local_compaction` (the ``tests/test_sparse_exec.py:231`` case and
random unions), `PackedDataset.flat_slot_mask` / `flat_len`, and every
rank's `to_mesh_window` slab against the matching rows of the reference's
padded flat window.  Then ports of the reference's world-1 mesh tests
(``tests/test_sparse_exec.py:253``, ``tests/test_streaming.py:270``,
``tests/test_engine_scan.py:218, :248, :270``,
``tests/test_psf_parity.py:175, :196``): the port's
`CoaddEngine.run_distributed` on a one-rank gloo group (a ``file://``
store under ``tmp_path``) against ``repro``'s on ``jax.make_mesh((1, 1))``
or ``((1,))``, at the reference's tolerances (1e-2 against the
single-host path, atol 1e-2 / rtol 1e-4 elsewhere, 1e-4 sparse against
dense), depth exactly.  The multi-rank meshes are in
``tests/test_torch_distributed_mesh.py``.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as rc
from repro.distributed.sharding import shard_local_compaction as rc_compaction
import repro_torch as rt
from repro_torch.core import engine as rt_engine
from repro_torch.distributed.sharding import (image_axis_slab, shard_index,
                                              shard_local_compaction)
from repro_torch.launch.mesh import make_mesh

CFG = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
QUERY = dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
QUERY2 = dict(band="r", ra_bounds=(37.3, 37.7), dec_bounds=(-0.4, 0.2), npix=32)
QUERY_G = dict(band="g", ra_bounds=(37.2, 37.7), dec_bounds=(-0.4, 0.2), npix=32)
FAR = dict(band="r", ra_bounds=(200.0, 201.0), dec_bounds=(50.0, 51.0), npix=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group for the test, through a file store under
    ``tmp_path``; destroyed after it, so no default group leaks."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _mesh(shape=(1, 1), axes=("data", "model")):
    return make_mesh(shape, axes, device_type="cpu")


def _queries(*qs):
    return [rc.CoaddQuery(**q) for q in qs], [rt.CoaddQuery(**q) for q in qs]


def _close(got, want, atol=1e-2, rtol=1e-4):
    np.testing.assert_allclose(got.coadd, want.coadd, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(got.depth, want.depth)


# ----- the host halves, bitwise the reference's ------------------------------

def test_shard_local_compaction_per_shard_budgets():
    """The reference's case (tests/test_sparse_exec.py:231), bitwise."""
    union = np.zeros((32,), bool)
    union[1] = True
    union[8:15] = True
    union[16] = union[18] = True
    got, want = shard_local_compaction(union, 4), rc_compaction(union, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype
    idx, mask, shared, budgets = got
    assert shared == 8 and list(budgets) == [1, 8, 2, 1]
    assert idx.shape == mask.shape == (4, 8)
    assert list(idx[0][:1]) == [1] and mask[0].sum() == 1
    assert list(idx[1][:7]) == list(range(0, 7)) and mask[1].sum() == 7
    assert list(idx[2][:2]) == [0, 2] and mask[2].sum() == 2
    assert mask[3].sum() == 0
    with pytest.raises(ValueError):
        shard_local_compaction(union, 5)


@pytest.mark.parametrize("seed", range(6))
def test_shard_local_compaction_random_unions_bitwise(seed):
    rng = np.random.default_rng(seed)
    n_shards = int(rng.choice([1, 2, 3, 4, 8]))
    local = int(rng.integers(1, 40))
    union = rng.random(n_shards * local) < rng.choice([0.0, 0.05, 0.3, 0.9])
    for g, w in zip(shard_local_compaction(union, n_shards), rc_compaction(union, n_shards)):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype
    if local > 1:
        with pytest.raises(ValueError):
            shard_local_compaction(union[:-1], n_shards if n_shards > 1 else 2)


@pytest.mark.parametrize("n_shards", [1, 3, 8, 7])
def test_flat_slot_mask_and_flat_len_bitwise(surveys, n_shards):
    er = rc.CoaddEngine(surveys[0], pack_capacity=16)
    et = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    ds_r, ds_t = er.dataset("structured"), et.dataset("structured")
    assert ds_t.flat_len(n_shards) == ds_r.flat_len(n_shards)
    for q in (QUERY, QUERY_G, FAR):
        ids = er.sql.select(rc.CoaddQuery(**q))
        np.testing.assert_array_equal(et.sql.select(rt.CoaddQuery(**q)), ids)
        for pad in (None, ds_r.flat_len(n_shards)):
            np.testing.assert_array_equal(ds_t.flat_slot_mask(ids, pad_to=pad),
                                          ds_r.flat_slot_mask(ids, pad_to=pad))


class _RankView:
    """A `DeviceMesh` as one rank of it sees it (names, rank layout and this
    rank's coordinate), without a process group: enough for the slab
    arithmetic, for every rank of a mesh in one process."""

    def __init__(self, shape, names, rank):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = tuple(names)
        self._coord = [int(c) for c in np.unravel_index(rank, shape)]

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("shape,names,axes", [
    ((4, 2), ("data", "model"), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data", "model")),
    ((4, 2), ("data", "model"), ("data",)),
    ((3,), ("data",), ("data",)),
])
def test_shard_index_row_major_over_named_axes(shape, names, axes):
    """Slab s of rank r is row-major over the named axes in their order,
    NamedSharding's order for a tuple of axes (held against the
    reference's 8-device sharding in test_torch_distributed_mesh.py)."""
    sizes = dict(zip(names, shape))
    for r in range(int(np.prod(shape))):
        view = _RankView(shape, names, r)
        coord = dict(zip(names, view.get_coordinate()))
        want = 0
        for a in axes:
            want = want * sizes[a] + coord[a]
        assert shard_index(view, axes) == want
        n = int(np.prod([sizes[a] for a in axes]))
        assert image_axis_slab(view, axes, 5 * n) == (5 * want, 5 * want + 5)


@pytest.mark.parametrize("psf", [None, 2.5])
@pytest.mark.parametrize("shape,names", [((4, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model")),
                                         ((3,), ("data",))])
def test_to_mesh_window_slabs_bitwise(surveys, shape, names, psf):
    """Each rank's slab of a window is bitwise the matching rows of the
    reference's padded flat window (image_id -1, fill 0 past the layout),
    its kernel bank too; windows must align to the shards."""
    er = rc.CoaddEngine(surveys[0], pack_capacity=16, match_psf_sigma=psf)
    et = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu", match_psf_sigma=psf)
    ds_r, ds_t = er.exec_dataset("structured")[0], et.exec_dataset("structured")[0]
    bank_r, bank_t = er.psf_kernel_bank("structured"), et.psf_kernel_bank("structured")
    n = int(np.prod(shape))
    jmesh = jax.make_mesh((1,), ("data",))
    m = ds_r.n_packs * ds_r.capacity
    pad_to = ds_t.flat_len(n)
    for start, stop in ((0, pad_to), (pad_to - 2 * n, pad_to + 3 * n), (n, 3 * n)):
        want = ds_r.to_mesh_window(jmesh, ("data",), start, stop, psf_kernels=bank_r)
        for r in range(n):
            view = _RankView(shape, names, r)
            got = ds_t.to_mesh_window(view, names, start, stop, "cpu", psf_kernels=bank_t)
            a, b = image_axis_slab(view, names, stop - start)
            assert got.start == start + a and got.n_flat == stop - start
            pairs = [(got.pixels, want.pixels), (got.wcs, want.wcs)]
            pairs += [(got.ints[k], want.ints[k]) for k in want.ints]
            pairs += [(got.floats[k], want.floats[k]) for k in want.floats]
            if psf is not None:
                pairs.append((got.psf_kernels, want.psf_kernels))
            else:
                assert got.psf_kernels is None and want.psf_kernels is None
            for g, w in pairs:
                w = np.asarray(w)[a:b]
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)
            assert (got.ints["image_id"].numpy()[max(m - start - a, 0):] == -1).all()
    with pytest.raises(ValueError, match="align"):
        ds_t.to_mesh_window(_RankView(shape, names, 0), names, 1, 1 + n, "cpu")


# ----- ports of the reference's world-1 mesh tests ----------------------------

def test_distributed_sparse_matches_dense(surveys, group):
    """tests/test_sparse_exec.py:253: per-shard local compaction gives the
    dense distributed answer, with the flat-gate stats; each against the
    reference's."""
    jm = jax.make_mesh((1, 1), ("data", "model"))
    mesh = _mesh()
    qr, qt = _queries(QUERY, QUERY2)
    ref_s = rc.CoaddEngine(surveys[0], pack_capacity=8, sparse=True).run_distributed(qr, jm)
    ref_d = rc.CoaddEngine(surveys[0], pack_capacity=8, sparse=False).run_distributed(qr, jm)
    rs = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                        sparse=True).run_distributed(qt, mesh)
    rd = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                        sparse=False).run_distributed(qt, mesh)
    for a, b, wa, wb in zip(rs, rd, ref_s, ref_d):
        assert b.depth.max() > 0
        _close(a, b, atol=1e-4, rtol=0)
        _close(a, wa)
        _close(b, wb)
        assert 0 < a.stats.packs_touched <= 1
        assert a.stats.packs_gated == a.stats.packs_touched
        assert a.stats.scan_budget <= b.stats.scan_budget
        for f in ("packs_touched", "packs_gated", "packs_scanned", "scan_budget", "windows",
                  "dispatches", "files_considered", "files_contributing"):
            assert getattr(a.stats, f) == getattr(wa.stats, f), f
            assert getattr(b.stats, f) == getattr(wb.stats, f), f
    assert rs[0].stats.packs_scanned == rs[0].stats.scan_budget
    assert rs[1].stats.packs_scanned == 0
    assert rs[0].stats.packs_scanned < rd[0].stats.packs_scanned


def test_distributed_streaming_matches_eager(surveys, group, monkeypatch):
    """tests/test_streaming.py:270: streamed mesh windows under a budget of a
    quarter of the structured layout against eager residency and the
    single-host path, windows and uploads as the reference counts them;
    one host sync a job."""
    jm = jax.make_mesh((1, 1), ("data", "model"))
    mesh = _mesh()
    ds = rc.CoaddEngine(surveys[0], pack_capacity=8).exec_dataset("structured")[0]
    budget = max(ds.chunk_nbytes(0, ds.n_packs) // 4, 1)
    qr, qt = _queries(QUERY, QUERY2)
    ref = rc.CoaddEngine(surveys[0], pack_capacity=8,
                         device_budget_bytes=budget).run_distributed(qr, jm)
    eager = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu")
    stream = rt.CoaddEngine(surveys[1], pack_capacity=8, device="cpu",
                            device_budget_bytes=budget)
    rd = eager.run_distributed(qt, mesh)
    syncs = []
    real_sync = rt_engine._sync
    monkeypatch.setattr(rt_engine, "_sync", lambda t: syncs.append(1) or real_sync(t))
    rs = stream.run_distributed(qt, mesh)
    assert len(syncs) == 1
    for a, b, w in zip(rd, rs, ref):
        assert a.depth.max() > 0
        _close(b, a)
        _close(b, w)
        for f in ("windows", "dispatches", "packs_scanned", "scan_budget", "packs_touched",
                  "chunk_uploads", "residency_hits", "residency_evictions",
                  "peak_resident_bytes"):
            assert getattr(b.stats, f) == getattr(w.stats, f), f
    assert rs[0].stats.windows > 1
    assert rs[0].stats.dispatches == rs[0].stats.windows
    assert stream.mesh_upload_count == rs[0].stats.chunk_uploads
    single = stream.run(qt[0], "sql_structured")
    np.testing.assert_allclose(rs[0].coadd, single.coadd, atol=1e-2, rtol=1e-4)


def test_distributed_mesh_resident_no_regather(surveys, group, monkeypatch):
    """tests/test_engine_scan.py:218: a second job on the same mesh uploads
    nothing; the cache keys the mesh by its layout, not the object."""
    mesh = _mesh()
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    r1 = eng.run_distributed([rt.CoaddQuery(**QUERY)], mesh)[0]
    assert r1.depth.max() > 0
    assert eng.mesh_upload_count == 1
    key = ("structured", rt_engine._mesh_key(mesh), ("data", "model"), None)
    mds = eng._mesh_cache[key]

    def _no_upload(self, *a, **k):
        raise AssertionError("host pixel upload on a repeat distributed job")

    monkeypatch.setattr(rt.core.seqfile.PackedDataset, "to_mesh", _no_upload)
    monkeypatch.setattr(rt.core.seqfile.PackedDataset, "to_mesh_window", _no_upload)
    monkeypatch.setattr(rt.core.seqfile.PackedDataset, "to_device", _no_upload)
    r2 = eng.run_distributed([rt.CoaddQuery(**QUERY_G)], _mesh())[0]
    assert eng.mesh_upload_count == 1
    assert eng._mesh_cache[key] is mds
    monkeypatch.undo()
    ref = rc.CoaddEngine(surveys[0], pack_capacity=16).run_distributed(
        [rc.CoaddQuery(**QUERY_G)], jax.make_mesh((1, 1), ("data", "model")))[0]
    _close(r2, ref)
    _close(r2, eng.run(rt.CoaddQuery(**QUERY_G), "sql_structured"))


def test_distributed_empty_jobs(surveys, group, monkeypatch):
    """tests/test_engine_scan.py:248: an empty job list, and a selection that
    matches nothing (zero coadds, no dispatch, no collective)."""
    mesh = _mesh()
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu")
    assert eng.run_distributed([], mesh) == []

    def _no_collective(*a, **k):
        raise AssertionError("a collective in an empty job")

    monkeypatch.setattr(dist, "all_reduce", _no_collective)
    monkeypatch.setattr(dist, "all_gather_into_tensor", _no_collective)
    before = eng.dispatch_count
    res = eng.run_distributed([rt.CoaddQuery(**FAR), rt.CoaddQuery(**FAR)], mesh)
    assert eng.dispatch_count == before
    ref = rc.CoaddEngine(surveys[0], pack_capacity=16).run_distributed(
        [rc.CoaddQuery(**FAR)] * 2, jax.make_mesh((1, 1), ("data", "model")))
    assert len(res) == 2
    for r, w in zip(res, ref):
        assert r.stats.dispatches == 0 == w.stats.dispatches
        assert r.stats.files_considered == 0
        assert np.all(r.coadd == 0) and np.all(r.depth == 0)
        np.testing.assert_array_equal(r.coadd, w.coadd)


def test_distributed_respects_use_kernel(surveys, group):
    """tests/test_engine_scan.py:270: use_kernel threads through the map (on
    the CPU the kernels' plain versions); both against the reference's
    XLA path."""
    mesh = _mesh()
    q = dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=32)
    ref = rc.CoaddEngine(surveys[0], pack_capacity=16).run_distributed(
        [rc.CoaddQuery(**q)], jax.make_mesh((1, 1), ("data", "model")))[0]
    r = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu",
                       use_kernel=False).run_distributed([rt.CoaddQuery(**q)], mesh)[0]
    r_k = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu",
                         use_kernel=True).run_distributed([rt.CoaddQuery(**q)], mesh)[0]
    assert r_k.depth.max() > 0
    np.testing.assert_allclose(r_k.coadd, r.coadd, atol=2e-2, rtol=1e-4)
    np.testing.assert_array_equal(r_k.depth, r.depth)
    _close(r, ref)
    _close(r_k, ref)


@pytest.mark.parametrize("measured", [None, False], ids=["measured", "gaussian"])
def test_distributed_psf_matched_matches_reference(surveys, group, measured):
    """Both bank ranks on the mesh path (the 2-D measured bank and the
    separable Gaussian fallback), 1-D mesh, against the reference and the
    port's single-host run."""
    kw = dict(data_axes=("data",), model_axis=None)
    qr, qt = _queries(QUERY, QUERY2)
    ref = rc.CoaddEngine(surveys[0], pack_capacity=16, match_psf_sigma=2.0,
                         measured_psf=measured).run_distributed(
        qr, jax.make_mesh((1,), ("data",)), **kw)
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu", match_psf_sigma=2.0,
                         measured_psf=measured)
    got = eng.run_distributed(qt, _mesh((1,), ("data",)), **kw)
    assert eng._mesh_cache[next(iter(eng._mesh_cache))].psf_kernels.dim() == (
        3 if measured is None else 2)
    for g, w, q in zip(got, ref, qt):
        assert g.depth.max() > 0
        _close(g, w)
        _close(g, eng.run(q, "sql_structured"))


def test_distributed_retune_resharded_bank(surveys, group):
    """tests/test_psf_parity.py:175: a retuned engine re-shards with the new
    target's bank; one sharded copy per (layout, mesh)."""
    mesh = _mesh((1,), ("data",))
    kw = dict(data_axes=("data",), model_axis=None)
    q = [rt.CoaddQuery(**QUERY)]
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu", match_psf_sigma=2.0)
    r_20 = eng.run_distributed(q, mesh, **kw)[0]
    eng.match_psf_sigma = 2.6
    r_26 = eng.run_distributed(q, mesh, **kw)[0]
    fresh = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu", match_psf_sigma=2.6)
    r_fresh = fresh.run_distributed(q, mesh, **kw)[0]
    np.testing.assert_array_equal(r_26.coadd, r_fresh.coadd)
    assert np.abs(r_26.coadd - r_20.coadd).max() > 1e-4
    assert len(eng._mesh_cache) == 1
    ref = rc.CoaddEngine(surveys[0], pack_capacity=16, match_psf_sigma=2.6).run_distributed(
        [rc.CoaddQuery(**QUERY)], jax.make_mesh((1,), ("data",)), **kw)[0]
    _close(r_26, ref)


def test_distributed_streaming_retune_rebuilds_windows(surveys, group):
    """tests/test_psf_parity.py:196: streamed mesh windows key on the PSF
    state too."""
    mesh = _mesh((1,), ("data",))
    kw = dict(data_axes=("data",), model_axis=None)
    ds = rc.CoaddEngine(surveys[0], pack_capacity=16).exec_dataset("structured")[0]
    budget = max(ds.chunk_nbytes(0, ds.n_packs) // 2, 1)
    q = [rt.CoaddQuery(**QUERY)]
    eng = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu", match_psf_sigma=2.0,
                         device_budget_bytes=budget)
    r_20 = eng.run_distributed(q, mesh, **kw)[0]
    eng.match_psf_sigma = 2.6
    r_26 = eng.run_distributed(q, mesh, **kw)[0]
    fresh = rt.CoaddEngine(surveys[1], pack_capacity=16, device="cpu", match_psf_sigma=2.6,
                           device_budget_bytes=budget)
    r_fresh = fresh.run_distributed(q, mesh, **kw)[0]
    np.testing.assert_array_equal(r_26.coadd, r_fresh.coadd)
    assert np.abs(r_26.coadd - r_20.coadd).max() > 1e-4
    ref = rc.CoaddEngine(surveys[0], pack_capacity=16, match_psf_sigma=2.6,
                         device_budget_bytes=budget).run_distributed(
        [rc.CoaddQuery(**QUERY)], jax.make_mesh((1,), ("data",)), **kw)[0]
    _close(r_26, ref)
    assert r_26.stats.windows == ref.stats.windows


def test_make_mesh_checks_its_group(group):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="not nccl"):
        make_mesh((1, 1), ("data", "model"), device_type="cpu", backend="nccl")
    with pytest.raises(ValueError, match="share npix"):
        rt.CoaddEngine(rt.make_survey(rt.SurveyConfig(**CFG)), device="cpu").run_distributed(
            [rt.CoaddQuery(**QUERY), rt.CoaddQuery(**dict(QUERY, npix=16))],
            make_mesh((1, 1), ("data", "model"), device_type="cpu"))
