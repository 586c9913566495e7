"""Host half of the PyTorch port, held bitwise against the JAX package.

The port keeps its own copies of the numpy modules (query, geometry, survey,
seqfile, prefilter, plan); on the same configuration they must produce the
very same bytes: survey pixels, WCS and metadata, the three layouts, the
reblock remap, the gates of all six planners, the query vectors, the query
grids and the sparse scan index.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.engine as rc_engine
import repro.core.mapper as rc_mapper
import repro.core.plan as rc_plan
import repro_torch as rt
import repro_torch.core.engine as rt_engine
import repro_torch.core.mapper as rt_mapper
import repro_torch.core.plan as rt_plan
from repro_torch import convert
from repro_torch.core import geometry as rt_geometry
from repro_torch.core import seqfile as rt_seqfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(n_runs=3, n_fields=5, n_sources=100, height=20, width=20)
QUERIES = [
    dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=48),
    dict(band="g", ra_bounds=(37.0, 37.6), dec_bounds=(-0.7, 0.1), npix=33),
    dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=40,
         time_bounds=(0.0, 99.0)),
    dict(band="z", ra_bounds=(200.0, 201.0), dec_bounds=(50.0, 51.0), npix=16),
]
LAYOUTS = ("per_file", "unstructured", "structured")


@pytest.fixture(scope="module")
def surveys():
    return rc.make_survey(rc.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))


@pytest.fixture(scope="module")
def engines(surveys):
    ref_sv, port_sv = surveys
    return (rc.CoaddEngine(ref_sv, pack_capacity=16),
            rt.CoaddEngine(port_sv, pack_capacity=16, device="cpu"))


def _packed_equal(a, b):
    assert a.layout == b.layout
    for name in ("pixels", "wcs", "valid", "pack_band", "pack_camcol", "psf_stamps"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    for cols in ("ints", "floats"):
        x, y = getattr(a, cols), getattr(b, cols)
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    assert a.index == b.index


def test_survey_bitwise(surveys):
    ref_sv, port_sv = surveys
    assert dataclasses.asdict(ref_sv.config) == dataclasses.asdict(port_sv.config)
    assert len(ref_sv) == len(port_sv)
    for a, b in zip(ref_sv.images, port_sv.images):
        assert (a.image_id, a.run, a.camcol, a.band_id, a.field, a.t_obs, a.psf_sigma) == (
            b.image_id, b.run, b.camcol, b.band_id, b.field, b.t_obs, b.psf_sigma)
        assert a.bounds == b.bounds
        assert np.array_equal(a.wcs.to_vector(), b.wcs.to_vector())
        assert a.pixels.dtype == b.pixels.dtype and np.array_equal(a.pixels, b.pixels)
        assert np.array_equal(a.psf_stamp, b.psf_stamp)
    for k, v in ref_sv.meta_table().items():
        assert np.array_equal(v, port_sv.meta_table()[k]), k
    for name in ("catalog_ra", "catalog_dec", "catalog_flux"):
        assert np.array_equal(getattr(ref_sv, name), getattr(port_sv, name))


def test_survey_process_pool_is_bitwise_serial():
    cfg = rt.SurveyConfig(n_runs=1, n_camcols=2, n_bands=2, n_fields=2, n_sources=30,
                          height=12, width=16)
    serial = rt.make_survey(cfg)
    pooled = rt.make_survey(cfg, processes=2)
    for a, b in zip(serial.images, pooled.images):
        assert np.array_equal(a.pixels, b.pixels)


def test_survey_epochs_are_a_prefix():
    """A survey with fewer epochs is the first frames of one with more
    (chip_smoke.py takes its reduced survey from the main one so)."""
    cfg = rt.SurveyConfig(n_runs=3, n_camcols=2, n_bands=2, n_fields=2, n_sources=30,
                          height=12, width=16)
    few = rt.make_survey(dataclasses.replace(cfg, n_runs=1))
    many = rt.make_survey(cfg)
    assert len(few) == len(many) // 3
    for a, b in zip(few.images, many.images):
        assert np.array_equal(a.pixels, b.pixels) and np.array_equal(a.psf_stamp, b.psf_stamp)
        assert (a.image_id, a.run, a.camcol, a.band_id, a.field, a.t_obs, a.wcs, a.bounds,
                a.psf_sigma) == (b.image_id, b.run, b.camcol, b.band_id, b.field, b.t_obs,
                                 b.wcs, b.bounds, b.psf_sigma)
    for name in ("catalog_ra", "catalog_dec", "catalog_flux"):
        assert np.array_equal(getattr(few, name), getattr(many, name))


@pytest.mark.parametrize("sigma,size,beta,e1,e2", [
    (1.3, 13, 3.5, 0.05, -0.02), (0.9, 7, None, 0.0, 0.1), (2.0, 9, 2.5, -0.2, 0.0)])
def test_render_psf_stamp_bitwise(sigma, size, beta, e1, e2):
    from repro.core.survey import render_psf_stamp as ref_stamp
    from repro_torch.core.survey import render_psf_stamp

    assert np.array_equal(ref_stamp(sigma, size, beta, e1, e2),
                          render_psf_stamp(sigma, size, beta, e1, e2))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_bitwise(engines, layout):
    ref_eng, port_eng = engines
    _packed_equal(ref_eng.dataset(layout), port_eng.dataset(layout))


@pytest.mark.parametrize("capacity", [4, 16, 64])
def test_reblock_and_remap_bitwise(engines, capacity):
    ref_eng, port_eng = engines
    ref_ds, ref_remap = ref_eng.dataset("per_file").reblock(capacity)
    port_ds, port_remap = port_eng.dataset("per_file").reblock(capacity)
    _packed_equal(ref_ds, port_ds)
    assert np.array_equal(ref_remap.rb_pack, port_remap.rb_pack)
    assert np.array_equal(ref_remap.rb_slot, port_remap.rb_slot)
    assert ref_remap.shape == port_remap.shape
    gate = ref_eng.dataset("per_file").valid.copy()
    gate[::3] = False
    assert np.array_equal(ref_remap.apply(gate), port_remap.apply(gate))


def test_exec_dataset_matches(engines):
    ref_eng, port_eng = engines
    for layout in LAYOUTS:
        (ref_ds, ref_remap), (port_ds, port_remap) = (
            ref_eng.exec_dataset(layout), port_eng.exec_dataset(layout))
        _packed_equal(ref_ds, port_ds)
        assert (ref_remap is None) == (port_remap is None)


@pytest.mark.parametrize("qi", range(len(QUERIES)))
@pytest.mark.parametrize("method", rt.METHODS)
def test_planner_gates_bitwise(engines, method, qi):
    ref_eng, port_eng = engines
    ref_plan = ref_eng.plan(rc.CoaddQuery(**QUERIES[qi]), method)
    port_plan = port_eng.plan(rt.CoaddQuery(**QUERIES[qi]), method)
    assert (ref_plan.method, ref_plan.layout) == (port_plan.method, port_plan.layout)
    assert ref_plan.gate.dtype == port_plan.gate.dtype
    assert np.array_equal(ref_plan.gate, port_plan.gate)
    assert np.array_equal(ref_plan.qvec, port_plan.qvec)
    assert ref_plan.packs_touched == port_plan.packs_touched
    assert np.array_equal(ref_eng._exec_gate(ref_plan), port_eng._exec_gate(port_plan))


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_query_vec_and_grid_bitwise(qi):
    ref_q, port_q = rc.CoaddQuery(**QUERIES[qi]), rt.CoaddQuery(**QUERIES[qi])
    v = rc_engine._query_vec(ref_q)
    assert v.dtype == np.float32 and np.array_equal(v, rt_engine._query_vec(port_q))
    assert np.array_equal(ref_q.grid_wcs_vector(), port_q.grid_wcs_vector())
    for a, b in zip(rc_mapper.query_grid_sky(ref_q), rt_mapper.query_grid_sky(port_q)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_spatial_index_and_globs_bitwise(surveys, engines):
    from repro.core import prefilter as rc_prefilter
    from repro_torch.core import prefilter as rt_prefilter

    ref_sv, port_sv = surveys
    ref_eng, port_eng = engines
    assert np.array_equal(rc_prefilter.camcol_dec_table(ref_sv),
                          rt_prefilter.camcol_dec_table(port_sv))
    for qd in QUERIES:
        rq, pq = rc.CoaddQuery(**qd), rt.CoaddQuery(**qd)
        assert np.array_equal(ref_eng.sql.select(rq), port_eng.sql.select(pq))
        assert np.array_equal(
            rc_prefilter.glob_file_mask(ref_sv.meta_table(), rq, ref_eng.camcol_dec),
            rt_prefilter.glob_file_mask(port_sv.meta_table(), pq, port_eng.camcol_dec))
        assert np.array_equal(
            rc_prefilter.glob_pack_mask(ref_eng.dataset("structured"), rq, ref_eng.camcol_dec),
            rt_prefilter.glob_pack_mask(port_eng.dataset("structured"), pq,
                                        port_eng.camcol_dec))


@pytest.mark.parametrize("n_gated,n_packs", [
    (0, 100), (1, 100), (3, 100), (4, 100), (5, 100), (64, 100), (65, 100), (7, 4), (0, 1)])
def test_scan_budget_matches(n_gated, n_packs):
    assert rc_plan.scan_budget(n_gated, n_packs) == rt_plan.scan_budget(n_gated, n_packs)


def test_scan_budget_rejects_empty_layout():
    with pytest.raises(ValueError):
        rt_plan.scan_budget(1, 0)


@pytest.mark.parametrize("seed", range(6))
def test_sparse_index_and_compaction_bitwise(seed):
    rng = np.random.default_rng(seed)
    p, cap = int(rng.integers(1, 40)), int(rng.integers(1, 9))
    gate = rng.random((p, cap)) < rng.choice([0.0, 0.02, 0.2, 0.9])
    a, b = rc_plan.sparse_pack_index(gate), rt_plan.sparse_pack_index(gate)
    assert a.pack_idx.dtype == b.pack_idx.dtype and np.array_equal(a.pack_idx, b.pack_idx)
    assert (a.n_gated, a.budget, a.n_packs, a.worthwhile) == (
        b.n_gated, b.budget, b.n_packs, b.worthwhile)
    assert np.array_equal(rc_plan.compact_gate(gate, a), rt_plan.compact_gate(gate, b))


def test_geometry_numpy_bitwise():
    from repro.core import geometry as rc_geometry

    rng = np.random.default_rng(3)
    v = np.array([37.4, -0.1, 9.5, 11.5, 4e-4, 1e-5, -2e-5, 5e-4])
    x, y = rng.uniform(-5, 25, 50), rng.uniform(-5, 25, 50)
    for a, b in zip(rc_geometry.pixel_to_sky(x, y, v), rt_geometry.pixel_to_sky(x, y, v)):
        assert np.array_equal(a, b)
    ra, dec = rng.uniform(37, 38, 50), rng.uniform(-0.5, 0.5, 50)
    for a, b in zip(rc_geometry.sky_to_pixel(ra, dec, v), rt_geometry.sky_to_pixel(ra, dec, v)):
        assert np.array_equal(a, b)
    w = rc_geometry.WCS.from_vector(v)
    assert rc_geometry.image_bounds(w, 20, 30) == rt_geometry.image_bounds(
        rt_geometry.WCS.from_vector(v), 20, 30)
    assert rc_geometry.make_grid_wcs(37.5, 0.1, 64, 0.5).to_vector().tobytes() == \
        rt_geometry.make_grid_wcs(37.5, 0.1, 64, 0.5).to_vector().tobytes()


def test_geometry_torch_matches_numpy():
    """The torch sky->pixel runs the numpy formula in float32.

    Float32 radians of an RA near 37 deg carry ~6e-8 rad of rounding, about
    0.01 px at this plate scale, so the float64 numpy result is held to 0.05 px.
    """
    rng = np.random.default_rng(4)
    v = np.array([37.4, -0.1, 9.5, 11.5, 4e-4, 1e-5, -2e-5, 5e-4], np.float32)
    ra = rng.uniform(37.39, 37.41, (8, 9)).astype(np.float32)
    dec = rng.uniform(-0.11, -0.09, (8, 9)).astype(np.float32)
    sx, sy = rt_geometry.sky_to_pixel(torch.from_numpy(ra), torch.from_numpy(dec),
                                      torch.from_numpy(v))
    ex, ey = rt_geometry.sky_to_pixel(ra.astype(np.float64), dec.astype(np.float64),
                                      v.astype(np.float64))
    assert sx.dtype == torch.float32
    np.testing.assert_allclose(sx.numpy(), ex, atol=0.05)
    np.testing.assert_allclose(sy.numpy(), ey, atol=0.05)


def test_convert_carries_survey_and_layouts(surveys):
    ref_sv, _ = surveys
    port_sv = convert.survey_from_reference(ref_sv)
    assert isinstance(port_sv, rt.Survey)
    eng = rt.CoaddEngine(port_sv, pack_capacity=16, device="cpu")
    ref_eng = rc.CoaddEngine(ref_sv, pack_capacity=16)
    for layout in LAYOUTS:
        ds = convert.packed_from_reference(ref_eng.dataset(layout))
        assert isinstance(ds, rt_seqfile.PackedDataset)
        _packed_equal(ds, eng.dataset(layout))


def test_device_dataset_uploads_once(engines):
    _, port_eng = engines
    before = port_eng.pack_upload_count
    dev = port_eng.device_dataset("structured")
    assert port_eng.device_dataset("structured") is dev
    assert port_eng.pack_upload_count - before in (0, 1)
    ds = port_eng.dataset("structured")
    assert dev.pixels.dtype == torch.float32 and dev.pixels.device.type == "cpu"
    assert np.array_equal(dev.pixels.numpy(), ds.pixels)
    assert dev.n_packs == ds.n_packs and dev.capacity == ds.capacity
    assert dev.nbytes >= ds.pixels.nbytes + ds.wcs.nbytes


def test_default_device_engine_raises_without_a_card(surveys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default engine runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.CoaddEngine(surveys[1])


def test_later_slice_arguments_rejected(surveys, engines):
    _, port_eng = engines
    # Ported: PSF matching is accepted and plans carry its target.
    psf_eng = rt.CoaddEngine(surveys[1], device="cpu", match_psf_sigma=2.0)
    assert psf_eng.plan(rt.CoaddQuery(**QUERIES[0]), "sql_structured").psf_target == 2.0
    # Ported: a device budget streams the query in residency windows.
    probe = rt.CoaddEngine(surveys[1], device="cpu")
    ds = probe.exec_dataset("structured")[0]
    budget_eng = rt.CoaddEngine(surveys[1], device="cpu",
                                device_budget_bytes=ds.chunk_nbytes(0, ds.n_packs) // 4)
    budget_plan = budget_eng.plan(rt.CoaddQuery(**QUERIES[0]), "unstructured_seq")
    assert budget_eng.execute(budget_plan).stats.windows > 1
    for reduce in ("clipped", "median"):   # ported: robust queries plan and run
        assert port_eng.plan(rt.CoaddQuery(**QUERIES[0]), "sql_structured",
                             reduce=reduce).reduce == reduce
    with pytest.raises(ValueError):
        port_eng.plan(rt.CoaddQuery(**QUERIES[0]), "sql_structured", reduce="trimmed")
    with pytest.raises(ValueError):
        port_eng.plan(rt.CoaddQuery(**QUERIES[0]), "no_such_method")


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.engine\n"
        "import repro_torch.core.bricks, repro_torch.core.detect, repro_torch.core.faults\n"
        "import repro_torch.core.jobtracker, repro_torch.core.seqfile\n"
        "import repro_torch.kernels.build, repro_torch.kernels.warp.ops\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'jaxlib' not in sys.modules\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_neither_jax_nor_the_reference():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{i}: {line.strip()}"


@pytest.mark.parametrize("lone", [False, True], ids=["repo", "lone_copy"])
def test_chip_smoke_fails_without_a_card(tmp_path, lone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if lone:
        dst = tmp_path / "chip_smoke.py"
        dst.write_bytes(open(script, "rb").read())
        script = str(dst)
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(script))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
