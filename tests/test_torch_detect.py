"""The port's difference imaging and detection, held against the JAX package's.

Ports tests/test_detect.py's seven tests onto ``repro_torch`` at their own
survey, query and seeds (the port's engine and detection on the CPU), then
holds the port against the reference on the same inputs:
``inject_transients`` bitwise, ``difference_image`` (values at 1e-3, the
reference's cross-path tolerance, tests/test_coadd_engine.py:26; depths
exactly), and ``detect_sources`` on the same difference and depth arrays
with x, y, npix and the count exact and flux and snr at 1e-4 relative
(summation order).  The synthetic cases pin the three places torch and
XLA differ by default: the median of an even count (``jnp.nanmedian``
averages the two middle values), the order of equal peak scores
(``lax.top_k`` keeps the lower index first) and the padding at the canvas
edge (-inf for the 3x3 maximum, 0 for the box sums).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
from repro.core.detect import sky_to_grid as rc_sky_to_grid
from repro_torch.core.detect import _nanmedian, epoch_time_bounds, sky_to_grid

CFG = dict(n_runs=3, n_fields=5, n_sources=100, height=20, width=20)
QUERY = dict(band="r", ra_bounds=(37.3, 37.9), dec_bounds=(-0.5, 0.3), npix=48)
PATH_ATOL = 1e-3
SNR_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors in parallel worker processes: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _detect(*arrays, **kw):
    return rt.detect_sources(*arrays, device="cpu", **kw)


@pytest.fixture(scope="module")
def injected():
    """(engine, truths): survey with 8 seeded transients in the last run."""
    sv = rt.make_survey(rt.SurveyConfig(**CFG))
    truths = rt.inject_transients(sv, rt.CoaddQuery(**QUERY), n=8, flux=400.0, seed=7)
    eng = rt.CoaddEngine(sv, pack_capacity=16, match_psf_sigma=2.0, device="cpu")
    return eng, truths


@pytest.fixture(scope="module")
def static_engine():
    return rt.CoaddEngine(rt.make_survey(rt.SurveyConfig(**CFG)), pack_capacity=16,
                          match_psf_sigma=2.0, device="cpu")


@pytest.fixture(scope="module")
def reference_injected():
    sv = rc.make_survey(rc.SurveyConfig(**CFG))
    truths = rc.inject_transients(sv, rc.CoaddQuery(**QUERY), n=8, flux=400.0, seed=7)
    return rc.CoaddEngine(sv, pack_capacity=16, match_psf_sigma=2.0), truths


# ----- tests/test_detect.py, on the port ------------------------------------

def test_epoch_time_bounds():
    sv = rt.make_survey(rt.SurveyConfig(n_runs=3, n_fields=2, n_sources=10, height=12,
                                        width=12))
    assert epoch_time_bounds(sv) == (200.0, 299.0)      # default: last run
    assert epoch_time_bounds(sv, run=0) == (0.0, 99.0)


def test_injection_is_seeded_and_separated():
    q = rt.CoaddQuery(**QUERY)
    sv_a, sv_b = rt.make_survey(rt.SurveyConfig(**CFG)), rt.make_survey(rt.SurveyConfig(**CFG))
    ta = rt.inject_transients(sv_a, q, n=8, seed=7)
    tb = rt.inject_transients(sv_b, q, n=8, seed=7)
    np.testing.assert_array_equal(ta, tb)               # same seed, same sky
    xa, ya = sky_to_grid(q, ta[:, 0], ta[:, 1])
    d2 = (xa[:, None] - xa) ** 2 + (ya[:, None] - ya) ** 2
    np.fill_diagonal(d2, np.inf)
    assert d2.min() >= 6.0 ** 2                         # pairwise min_sep_px
    with pytest.raises(ValueError):
        rt.inject_transients(rt.make_survey(rt.SurveyConfig(**CFG)), q, n=40, min_sep_px=50.0)


def test_recovers_95pct_with_zero_false_positives(injected):
    eng, truths = injected
    q = rt.CoaddQuery(**QUERY)
    diff, d_epoch, d_tmpl = rt.difference_image(eng, q, reduce="clipped")
    assert diff.shape == (q.npix, q.npix)
    assert d_tmpl.max() > d_epoch.max()  # template is the deeper stack
    cat = _detect(diff, d_epoch, d_tmpl, nsigma=5.0)
    recovered, spurious = rt.match_detections(cat, q, truths)
    assert recovered >= int(np.ceil(0.95 * len(truths)))
    assert spurious == 0
    assert (cat.snr >= 5.0).all()
    assert (cat.npix >= 1).all()
    assert (cat.flux > 0).all()          # transients were *added* flux


def test_static_sky_yields_zero_detections(static_engine):
    q = rt.CoaddQuery(**QUERY)
    diff, d_epoch, d_tmpl = rt.difference_image(static_engine, q, reduce="clipped")
    cat = _detect(diff, d_epoch, d_tmpl, nsigma=5.0)
    assert len(cat) == 0
    assert rt.match_detections(cat, q, np.zeros((0, 2))) == (0, 0)


def test_max_sources_truncates_but_keeps_brightest(injected):
    eng, _ = injected
    diff, d_epoch, d_tmpl = rt.difference_image(eng, rt.CoaddQuery(**QUERY), reduce="clipped")
    full = _detect(diff, d_epoch, d_tmpl, nsigma=5.0)
    trunc = _detect(diff, d_epoch, d_tmpl, nsigma=5.0, max_sources=3)
    assert len(trunc) == min(3, len(full))
    np.testing.assert_array_equal(trunc.snr, np.sort(full.snr)[::-1][:3])


def test_difference_respects_chosen_run(injected):
    eng, truths = injected
    q = rt.CoaddQuery(**QUERY)
    diff, d_epoch, d_tmpl = rt.difference_image(eng, q, run=0, reduce="clipped")
    cat = _detect(diff, d_epoch, d_tmpl, nsigma=5.0)
    recovered, _ = rt.match_detections(cat, q, truths)
    assert recovered == 0


def test_mean_template_also_recovers(injected):
    eng, truths = injected
    q = rt.CoaddQuery(**QUERY)
    diff, d_epoch, d_tmpl = rt.difference_image(eng, q, reduce="mean", use_bricks=False)
    cat = _detect(diff, d_epoch, d_tmpl, nsigma=5.0)
    recovered, spurious = rt.match_detections(cat, q, truths)
    assert recovered >= int(np.ceil(0.95 * len(truths)))
    assert spurious == 0


# ----- the port against the reference ---------------------------------------

def _hold_catalog(got, want):
    assert len(got) == len(want)
    for f in ("x", "y", "npix"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.flux, np.asarray(want.flux), rtol=SNR_RTOL, atol=1e-5)
    np.testing.assert_allclose(got.snr, np.asarray(want.snr), rtol=SNR_RTOL)


def test_injection_bitwise_the_reference():
    q_rt, q_rc = rt.CoaddQuery(**QUERY), rc.CoaddQuery(**QUERY)
    sv_rt, sv_rc = rt.make_survey(rt.SurveyConfig(**CFG)), rc.make_survey(rc.SurveyConfig(**CFG))
    for kw in (dict(n=8, seed=7), dict(n=5, flux=250.0, run=1, seed=3, min_sep_px=4.0)):
        np.testing.assert_array_equal(rt.inject_transients(sv_rt, q_rt, **kw),
                                      rc.inject_transients(sv_rc, q_rc, **kw))
    for a, b in zip(sv_rt.images, sv_rc.images):
        np.testing.assert_array_equal(a.pixels, b.pixels)
    ra, dec = np.array([37.4, 37.55]), np.array([-0.2, 0.1])
    for a, b in zip(sky_to_grid(q_rt, ra, dec), rc_sky_to_grid(q_rc, ra, dec)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reduce, use_bricks", [("clipped", True), ("mean", False),
                                                ("median", True)])
def test_difference_and_catalog_match_the_reference(injected, reference_injected, reduce,
                                                    use_bricks):
    eng, truths = injected
    ref_eng, ref_truths = reference_injected
    np.testing.assert_array_equal(truths, ref_truths)
    got = rt.difference_image(eng, rt.CoaddQuery(**QUERY), reduce=reduce,
                              use_bricks=use_bricks)
    want = rc.difference_image(ref_eng, rc.CoaddQuery(**QUERY), reduce=reduce,
                               use_bricks=use_bricks)
    np.testing.assert_allclose(got[0], want[0], atol=PATH_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # The same arrays through both detectors, then each package's own.
    _hold_catalog(_detect(*want), rc.detect_sources(*want))
    _hold_catalog(_detect(*got), rc.detect_sources(*want))


def test_brick_aligned_difference_matches_the_reference():
    """The brick-served template (lattice grid) against the epoch on the
    query's own grid, in both packages (CoaddEngine defaults: brick_deg 0.25,
    brick_npix 64), on a survey with transients in its last run."""
    cfg = dict(CFG, n_fields=8)
    sv_rt, sv_rc = rt.make_survey(rt.SurveyConfig(**cfg)), rc.make_survey(rc.SurveyConfig(**cfg))
    eng = rt.CoaddEngine(sv_rt, pack_capacity=16, device="cpu", brick_npix=32)
    ref_eng = rc.CoaddEngine(sv_rc, pack_capacity=16, brick_npix=32)
    q_rt = eng.brick_grid.window_query(2, 4, 1, 3, "r")
    q_rc = ref_eng.brick_grid.window_query(2, 4, 1, 3, "r")
    truths = rt.inject_transients(sv_rt, q_rt, n=4, seed=7)
    np.testing.assert_array_equal(truths, rc.inject_transients(sv_rc, q_rc, n=4, seed=7))
    got = rt.difference_image(eng, q_rt, reduce="clipped")
    want = rc.difference_image(ref_eng, q_rc, reduce="clipped")
    np.testing.assert_allclose(got[0], want[0], atol=PATH_ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _hold_catalog(_detect(*got), rc.detect_sources(*want))
    assert eng.warm_brick_cover(q_rt, "clipped") is not None   # the template was bricks


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 8, 575, 576])
def test_nanmedian_is_the_references(n_valid):
    rng = np.random.default_rng(n_valid)
    a = rng.normal(size=(24, 24)).astype(np.float32)
    a[np.unravel_index(rng.permutation(a.size)[n_valid:], a.shape)] = np.nan
    assert int(np.isfinite(a).sum()) == n_valid
    got = float(_nanmedian(torch.from_numpy(a)))
    want = float(jnp.nanmedian(jnp.asarray(a)))
    assert (np.isnan(got) and np.isnan(want)) or got == want
    if n_valid == 2:       # the mean of the two, not the lower one
        assert got != float(torch.nanmedian(torch.from_numpy(a)))


def _field(seed, q=32):
    """A noisy difference with depth maps holding some invalid pixels."""
    rng = np.random.default_rng(seed)
    diff = rng.normal(size=(q, q)).astype(np.float32)
    da = rng.integers(1, 6, size=(q, q)).astype(np.float32)
    db = np.full((q, q), 8.0, np.float32)
    return diff, da, db


@pytest.mark.parametrize("parity", ["even", "odd"])
def test_detect_with_even_and_odd_valid_counts(parity):
    diff, da, db = _field(1)
    da[0, :7] = 0.0                       # 1017 valid pixels: odd
    if parity == "even":
        da[0, 7] = 0.0                    # 1016: the median averages two
    assert int(((da > 0) & (db > 0)).sum()) % 2 == (parity == "odd")
    for y, x, v in ((5, 9, 30.0), (20, 14, 18.0), (27, 3, 12.0)):
        diff[y, x] = v
    want = rc.detect_sources(diff, da, db, nsigma=4.0)
    got = _detect(diff, da, db, nsigma=4.0)
    assert len(got) >= 3
    _hold_catalog(got, want)


@pytest.mark.parametrize("max_sources", [1, 2, 32])
def test_detect_breaks_ties_toward_the_lower_index(max_sources):
    diff, _, _ = _field(2)
    da = np.full_like(diff, 4.0)
    db = np.full_like(diff, 8.0)
    for y, x in ((22, 25), (6, 11), (14, 3)):   # equal peaks, equal depths
        diff[y, x] = 25.0
    want = rc.detect_sources(diff, da, db, max_sources=max_sources)
    got = _detect(diff, da, db, max_sources=max_sources)
    _hold_catalog(got, want)
    assert got.snr[0] == got.snr[min(2, len(got) - 1)]
    assert (got.y[0], got.x[0]) == (6, 11)     # the lowest flat index of the three


def test_detect_peaks_at_the_canvas_edge():
    diff, da, db = _field(3)
    for y, x, v in ((0, 0, 40.0), (0, 17, 35.0), (31, 31, 30.0), (15, 0, 25.0), (31, 8, 22.0)):
        diff[y, x] = v
        diff[min(y + 1, 31), x] = v / 3       # a neighbour above threshold
    want = rc.detect_sources(diff, da, db)
    got = _detect(diff, da, db)
    _hold_catalog(got, want)
    edge = {(0, 0), (0, 17), (31, 31), (15, 0), (31, 8)}
    assert edge <= set(zip(got.y.tolist(), got.x.tolist()))


def test_detect_on_an_invalid_canvas_finds_nothing():
    diff, da, db = _field(4, q=8)
    da[:] = 0.0
    assert len(_detect(diff, da, db)) == 0 == len(rc.detect_sources(diff, da, db))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_detection_matches_the_cpu(cuda):
    diff, da, db = _field(5)
    diff[10, 12] = 30.0
    got = rt.detect_sources(diff, da, db, device=cuda)
    _hold_catalog(got, _detect(diff, da, db))


def test_difference_image_epoch_is_time_bounded(injected):
    eng, _ = injected
    q = rt.CoaddQuery(**QUERY)
    diff, d_epoch, _ = rt.difference_image(eng, q, reduce="mean", use_bricks=False)
    epoch = eng.run(dataclasses.replace(q, time_bounds=epoch_time_bounds(eng.survey)),
                    "sql_structured")
    np.testing.assert_array_equal(d_epoch, epoch.depth)
