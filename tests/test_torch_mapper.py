"""The port's map and reduce stages in plain torch, held against the JAX ones.

The reference runs its mapper inside jitted programs, so it is jitted here
too: XLA rewrites a product with a converted mask into a select, which makes
an uncovered sample (and an empty slot's NaN coordinates) exactly 0; the port
does the same explicitly.  Tiles are held at atol 2e-2 / rtol 1e-4, the
reference's kernel-vs-oracle tolerance (tests/test_kernels.py:30), because
XLA's and torch's float32 sin/cos may differ by an ulp; coverage exactly,
except within 1e-3 px of an image edge (`ref.coverage_flips`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.engine as rc_engine
import repro.core.mapper as rc_mapper
import repro.core.reducer as rc_reducer
import repro_torch as rt
import repro_torch.core.engine as rt_engine
from repro_torch.core import mapper, reducer
from repro_torch.kernels.warp import ref

ATOL, RTOL = 2e-2, 1e-4
CFG = dict(n_runs=2, n_fields=3, n_sources=40, height=24, width=24)
QUERIES = [
    dict(band="r", ra_bounds=(37.1, 37.6), dec_bounds=(-0.5, 0.1), npix=32),
    dict(band="g", ra_bounds=(37.0, 37.7), dec_bounds=(-0.7, 0.3), npix=45),
    dict(band="r", ra_bounds=(36.8, 37.3), dec_bounds=(-1.6, -0.9), npix=20),
]

_map_batch_ref = jax.jit(rc_mapper.map_batch, static_argnames=("use_kernel", "block_rows",
                                                               "interpret"))
_project_one_ref = jax.jit(rc_mapper.project_one)
_bilinear_ref = jax.jit(rc_mapper.bilinear_sample)


@pytest.fixture(scope="module")
def survey():
    return rt.make_survey(rt.SurveyConfig(**CFG))


def _batch(survey, qd, n=6, empty=1):
    """Images the query selects, plus ``empty`` all-zero slots (zero WCS)."""
    q = rt.CoaddQuery(**qd)
    ids = rt.SpatialIndex.build(survey).select(q)[:n]
    if len(ids) == 0:
        ids = np.arange(n)
    px = np.stack([survey.images[i].pixels for i in ids] + [np.zeros((24, 24), np.float32)] * empty)
    wv = np.stack([survey.images[i].wcs.to_vector() for i in ids] + [np.zeros(8, np.float32)] * empty)
    gr, gd = mapper.query_grid_sky(q)
    return px, wv, gr, gd


def _hold(tiles, covs, tiles_ref, covs_ref, wv, acc, gr, gd, h, w):
    tiles, covs = torch.as_tensor(tiles), torch.as_tensor(covs)
    tiles_ref, covs_ref = torch.tensor(np.asarray(tiles_ref)), torch.tensor(np.asarray(covs_ref))
    flips = 0
    for i in range(tiles.shape[0]):
        near, far = ref.coverage_flips(covs[i], covs_ref[i], h, w,
                                       torch.as_tensor(wv[i:i + 1]),
                                       torch.as_tensor(acc[i:i + 1]),
                                       torch.as_tensor(gr), torch.as_tensor(gd))
        assert not far.any(), f"image {i}: coverage differs away from the edges"
        keep = ~near
        np.testing.assert_allclose(tiles[i][keep].numpy(), tiles_ref[i][keep].numpy(),
                                   atol=ATOL, rtol=RTOL)
        flips += int(near.sum())
    assert torch.isfinite(tiles).all()
    return flips


@pytest.mark.parametrize("accept", ["all", "half", "none"])
@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_map_batch_matches_reference(survey, qi, accept):
    px, wv, gr, gd = _batch(survey, QUERIES[qi])
    n = px.shape[0]
    acc = {"all": np.ones(n, bool), "half": np.arange(n) % 2 == 0,
           "none": np.zeros(n, bool)}[accept]
    t_ref, c_ref = _map_batch_ref(jnp.asarray(px), jnp.asarray(wv), jnp.asarray(acc),
                                  jnp.asarray(gr), jnp.asarray(gd))
    t, c = mapper.map_batch(torch.from_numpy(px), torch.from_numpy(wv),
                            torch.from_numpy(acc), torch.from_numpy(gr), torch.from_numpy(gd))
    assert t.shape == c.shape == (n,) + gr.shape and t.dtype == torch.float32
    _hold(t, c, t_ref, c_ref, wv, acc.astype(np.float32), gr, gd, 24, 24)
    if accept == "none":
        assert not t.any() and not c.any()
    # The empty slot (last) adds exact zeros, never NaN.
    assert not t[-1].any() and not c[-1].any()


@pytest.mark.parametrize("i", range(5))
def test_project_one_matches_reference(survey, i):
    px, wv, gr, gd = _batch(survey, QUERIES[i % 2], n=5, empty=0)
    k = min(i, px.shape[0] - 1)
    t_ref, c_ref = _project_one_ref(jnp.asarray(px[k]), jnp.asarray(wv[k]),
                                    jnp.float32(1.0), jnp.asarray(gr), jnp.asarray(gd))
    t, c = mapper.project_one(torch.from_numpy(px[k]), torch.from_numpy(wv[k]),
                              torch.tensor(1.0), torch.from_numpy(gr), torch.from_numpy(gd))
    _hold(t[None], c[None], np.asarray(t_ref)[None], np.asarray(c_ref)[None],
          wv[k:k + 1], np.ones(1, np.float32), gr, gd, 24, 24)


@pytest.mark.parametrize("seed", range(4))
def test_bilinear_sample_matches_reference(seed):
    """Coordinates in and out of the image, far outside, and NaN."""
    rng = np.random.default_rng(seed)
    img = rng.normal(10, 3, (17, 23)).astype(np.float32)
    sx = rng.uniform(-3, 26, (9, 11)).astype(np.float32)
    sy = rng.uniform(-3, 20, (9, 11)).astype(np.float32)
    sx[0, :4] = [0.0, 22.0, -1e9, 1e9]
    sy[1, :4] = [0.0, 16.0, -1e9, 1e9]
    sx[2, 0] = np.nan
    v_ref, m_ref = _bilinear_ref(jnp.asarray(img), jnp.asarray(sx), jnp.asarray(sy))
    v, m = mapper.bilinear_sample(torch.from_numpy(img), torch.from_numpy(sx),
                                  torch.from_numpy(sy))
    assert np.array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-5, rtol=1e-6)
    assert v[2, 0] == 0 and m[2, 0] == 0


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_accept_from_meta_matches_reference(survey, qi):
    eng = rt.CoaddEngine(survey, pack_capacity=8, device="cpu")
    ds = eng.dataset("unstructured")
    for qd in (QUERIES[qi], {**QUERIES[qi], "time_bounds": (0.0, 99.0)}):
        qvec = rt_engine._query_vec(rt.CoaddQuery(**qd))
        a_ref = rc_engine._accept_from_meta(
            {k: jnp.asarray(v) for k, v in ds.ints.items()},
            {k: jnp.asarray(v) for k, v in ds.floats.items()}, jnp.asarray(qvec))
        a = rt_engine._accept_from_meta(
            {k: torch.from_numpy(v) for k, v in ds.ints.items()},
            {k: torch.from_numpy(v) for k, v in ds.floats.items()}, torch.from_numpy(qvec))
        assert a.dtype == torch.bool and np.array_equal(a.numpy(), np.asarray(a_ref))
        m_ref = rc_mapper.acceptance_mask(
            ds.ints["band_id"], ds.valid, ds.floats["t_obs"], ds.floats["ra_min"],
            ds.floats["ra_max"], ds.floats["dec_min"], ds.floats["dec_max"],
            rc.CoaddQuery(**qd))
        m = mapper.acceptance_mask(
            torch.from_numpy(ds.ints["band_id"]), torch.from_numpy(ds.valid),
            torch.from_numpy(ds.floats["t_obs"]), torch.from_numpy(ds.floats["ra_min"]),
            torch.from_numpy(ds.floats["ra_max"]), torch.from_numpy(ds.floats["dec_min"]),
            torch.from_numpy(ds.floats["dec_max"]), rt.CoaddQuery(**qd))
        assert np.array_equal(m.numpy(), np.asarray(m_ref))


def test_gather_packs(survey):
    eng = rt.CoaddEngine(survey, pack_capacity=8, device="cpu")
    dev = eng.device_dataset("structured")
    idx = torch.tensor([3, 0, 3], dtype=torch.int32)
    px, wv, ints, floats, kern = mapper.gather_packs(idx, dev.pixels, dev.wcs, dev.ints,
                                                     dev.floats)
    assert px.shape == (3,) + tuple(dev.pixels.shape[1:])
    assert torch.equal(px[0], dev.pixels[3]) and torch.equal(px[1], dev.pixels[0])
    assert torch.equal(wv[2], dev.wcs[3])
    assert torch.equal(ints["image_id"][1], dev.ints["image_id"][0])
    assert kern is None
    bank = torch.arange(dev.pixels.shape[0] * dev.pixels.shape[1] * 3,
                        dtype=torch.float32).reshape(dev.pixels.shape[:2] + (3,))
    px1, wv1, _, _, kern1 = mapper.gather_packs(2, dev.pixels, dev.wcs, {}, {}, bank)
    assert torch.equal(px1, dev.pixels[2]) and torch.equal(wv1, dev.wcs[2])
    assert torch.equal(kern1, bank[2])


@pytest.mark.parametrize("seed", range(3))
def test_reduce_and_normalize_match_reference(seed):
    rng = np.random.default_rng(seed)
    tiles = rng.normal(5, 2, (7, 13, 13)).astype(np.float32)
    covs = (rng.random((7, 13, 13)) < 0.4).astype(np.float32) * rng.choice([0.5, 1.0], (7, 1, 1))
    tiles *= covs > 0
    c_ref, d_ref = rc_reducer.reduce_local(jnp.asarray(tiles), jnp.asarray(covs))
    c, d = reducer.reduce_local(torch.from_numpy(tiles), torch.from_numpy(covs))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5, rtol=1e-6)
    assert np.array_equal(d.numpy(), np.asarray(d_ref))
    assert (d == 0).any()
    n_ref = rc_reducer.normalize(c_ref, d_ref)
    n = reducer.normalize(c, d)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_ref), atol=1e-6, rtol=1e-6)
    assert (n[d == 0] == 0).all() and torch.isfinite(n).all()
