"""The port's PSF matching (``match_psf_sigma``), held against the JAX package.

* Host banks: ``repro_torch.core.psf``'s numpy bank solving against
  ``repro.core.psf`` bitwise (Moffat and Gaussian stamps, a stamp too wide
  for the target with its RuntimeWarning, empty slots, explicit radius 0).
* Convolutions: the torch edge-clamped correlations against the
  reference's ``convolve_separable`` / ``convolve_2d`` / ``convolve_batch``
  at atol 1e-5; the port correlates everywhere, which the reference's
  ``convolve_separable`` (``jnp.convolve``, a flip) matches only for the
  symmetric rows its banks emit.
* Kernels: ``psf_match_ref`` plus each plain scan against the reference's
  Pallas ``coadd_fused`` / ``coadd_moments`` / ``coadd_hist`` /
  ``coadd_clip`` in interpret mode with (N, K) and (N, K, K) banks: values
  at atol 2e-2 / rtol 1e-4 (tests/test_kernels.py:30), depth, coverage and
  bins exactly.
* Engine: all six methods x three estimators x {measured bank, Gaussian
  fallback} against the reference's XLA path and its Pallas path, coadd at
  1e-3 (tests/test_system.py:50), depth exactly.
* Ports of the deterministic checks of tests/test_psf.py,
  tests/test_psf_properties.py and tests/test_psf_parity.py.

The CUDA kernels run only on a card: those tests carry the ``gpu`` marker
and skip here (``python3 chip_smoke.py`` drives them at full size).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch as rt
from repro.core import psf as ref_psf
from repro.kernels.warp import ops as ref_ops
from repro.kernels.warp.warp import _convolve_2d_matmul, _convolve_sep_matmul
from repro_torch.core import psf, reducer
from repro_torch.core.mapper import query_grid_sky
from repro_torch.core.survey import render_psf_stamp
from repro_torch.kernels.warp import ops, ref

ATOL, RTOL = 2e-2, 1e-4          # kernel vs oracle (tests/test_kernels.py:30)
CONV_ATOL = 1e-5                 # convolution vs convolution, unit-scale images
ENGINE_ATOL = 1e-3               # across engines (tests/test_system.py:50)
TARGET = 2.0                     # tests/test_psf_parity.py's target
MAIN_TARGET = 2.5                # the H100 main path's target: no slot clamps
CLIP_K, NBINS = 3.0, 16
REDUCES = ("mean", "clipped", "median")
SMALL = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
GAUSS = dict(SMALL, moffat_beta=None, psf_ellip_jitter=0.0, psf_stamp_size=17)
QUERY = dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
STAMP = 17                       # tests/test_psf_properties.py's tap grid


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def moffat():
    """The default measured-PSF survey (elliptical Moffat stamps), both packages."""
    return rc.make_survey(rc.SurveyConfig(**SMALL)), rt.make_survey(rt.SurveyConfig(**SMALL))


@pytest.fixture(scope="module")
def gaussian():
    """Stamps rendered as exact circular Gaussians, 17 taps
    (tests/test_psf_parity.py: the case where both banks must agree)."""
    return rc.make_survey(rc.SurveyConfig(**GAUSS)), rt.make_survey(rt.SurveyConfig(**GAUSS))


# ----- host banks, bitwise ----------------------------------------------------

@pytest.mark.parametrize("sigma,radius", [(0.7, None), (1.5, None), (2.3, None), (1.5, 0),
                                          (1.5, 4), (0.0, None), (-1.0, 3)])
def test_gaussian_kernel_1d_matches_reference(sigma, radius):
    # A float32 jnp function in the reference: XLA's exp and sum round in
    # their own order, so the taps agree to an ulp, not bitwise.
    want = np.asarray(ref_psf.gaussian_kernel_1d(sigma, radius))
    got = psf.gaussian_kernel_1d(sigma, radius).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if radius == 0 or sigma <= 0:
        assert got.tolist() == [1.0]


SIGMA_CASES = {
    "mixed": (np.array([1.0, 1.4, 2.0, 2.6], np.float32), None),
    "empty_slots": (np.array([1.1, 0.0, -1.0, 1.7], np.float32), None),
    "all_noop": (np.array([2.0, 3.0, 0.0], np.float32), None),
    "explicit_radius": (np.array([1.0, 1.9], np.float32), 8),
    "radius_0": (np.array([1.0, 1.9], np.float32), 0),
    "layout": (np.random.default_rng(3).uniform(0.9, 1.7, (5, 7)).astype(np.float32), None),
}


@pytest.mark.parametrize("case", SIGMA_CASES)
@pytest.mark.parametrize("target", [TARGET, MAIN_TARGET])
def test_matching_kernel_bank_bitwise(case, target):
    sigmas, radius = SIGMA_CASES[case]
    want = ref_psf.matching_kernel_bank(sigmas, target, radius)
    got = psf.matching_kernel_bank(sigmas, target, radius)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def _moffat(sigma, e1, e2, beta=3.5, size=STAMP):
    return np.asarray(render_psf_stamp(sigma, size, beta, e1, e2), np.float64)


def _stamps(kind, n=6, size=13, seed=7):
    rng = np.random.default_rng(seed)
    pars = rng.uniform([0.9, -0.1, -0.1], [1.6, 0.1, 0.1], (n, 3))
    beta = None if kind == "gaussian" else 3.5
    st = np.stack([render_psf_stamp(s, size, beta, e1, e2) for s, e1, e2 in pars])
    return st.astype(np.float32), pars[:, 0].astype(np.float32)


def test_stamp_helpers_bitwise():
    st, _ = _stamps("moffat")
    for size in (1, 13, 17):
        assert np.array_equal(psf.gaussian_stamp(2.1, size), ref_psf.gaussian_stamp(2.1, size))
        assert np.array_equal(psf._delta_stamp(size), ref_psf._delta_stamp(size))
    assert np.array_equal(psf.stamp_sigma(st), ref_psf.stamp_sigma(st))
    assert np.array_equal(psf.stamp_sigma(np.zeros((2, 13, 13))),
                          ref_psf.stamp_sigma(np.zeros((2, 13, 13))))
    assert np.array_equal(psf._center_embed(st[0], 25), ref_psf._center_embed(st[0], 25))
    for target in (psf.gaussian_stamp(2.2, 13), st[1]):
        assert np.array_equal(psf.homogenization_kernel(st[0], target),
                              ref_psf.homogenization_kernel(st[0], target))
    with np.errstate(invalid="ignore"):   # a zero stamp: 0/0 in both
        assert np.array_equal(psf.homogenization_kernel(np.zeros((13, 13)), st[1]),
                              ref_psf.homogenization_kernel(np.zeros((13, 13)), st[1]),
                              equal_nan=True)
    with pytest.raises(ValueError, match="odd"):
        psf.gaussian_stamp(2.0, 12)


@pytest.mark.parametrize("kind", ["moffat", "gaussian"])
@pytest.mark.parametrize("target", [TARGET, MAIN_TARGET])
def test_homogenization_bank_bitwise(kind, target):
    st, sig = _stamps(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no stamp is wider than these targets
        want = ref_psf.homogenization_bank(st, sig, target)
        got = psf.homogenization_bank(st, sig, target)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_homogenization_bank_clamp_and_empty_bitwise():
    """A layout-shaped (P, cap) bank with empty slots and stamps too wide
    for the target: the same delta rows, the same warning, the same bytes."""
    st, sig = _stamps("moffat", n=8)
    st[2] = 0.0
    sig[5] = 0.0
    st, sig = st.reshape(2, 4, 13, 13), sig.reshape(2, 4)
    target = 1.2                     # below the widest stamps: they clamp
    with pytest.warns(RuntimeWarning, match="never deconvolves") as rec_ref:
        want = ref_psf.homogenization_bank(st, sig, target)
    with pytest.warns(RuntimeWarning, match="never deconvolves") as rec:
        got = psf.homogenization_bank(st, sig, target)
    assert str(rec[0].message) == str(rec_ref[0].message)
    assert got.shape == (2, 4, 13, 13) and np.array_equal(got, want)
    delta = psf._delta_stamp(13).astype(np.float32)
    assert np.array_equal(got[0, 2], delta) and np.array_equal(got[1, 1], delta)
    with pytest.raises(ValueError, match="odd square"):
        psf.homogenization_bank(np.zeros((2, 12, 12)), np.ones(2), 2.0)


def test_survey_layout_banks_bitwise(moffat):
    """The banks the engines build for one layout, in execution form."""
    ref_eng = rc.CoaddEngine(moffat[0], pack_capacity=16, match_psf_sigma=MAIN_TARGET)
    port_eng = rt.CoaddEngine(moffat[1], pack_capacity=16, match_psf_sigma=MAIN_TARGET,
                              device="cpu")
    for measured in (None, False):
        ref_eng.measured_psf = port_eng.measured_psf = measured
        for layout in ("per_file", "unstructured", "structured"):
            want = ref_eng.psf_kernel_bank(layout)
            got = port_eng.psf_kernel_bank(layout)
            assert got.ndim == (4 if measured is None else 3)
            assert got.shape[:2] == port_eng.exec_dataset(layout)[0].pixels.shape[:2]
            assert np.array_equal(got, want), (measured, layout)


# ----- convolutions -----------------------------------------------------------

def _image(h, w, seed=0):
    return np.random.default_rng(seed).normal(size=(h, w)).astype(np.float32)


@pytest.mark.parametrize("hw", [(16, 16), (16, 11), (5, 4), (1, 9)])
@pytest.mark.parametrize("sigma", [0.8, 1.9])
def test_convolve_separable_matches_reference(hw, sigma):
    img = _image(*hw)
    row = np.asarray(ref_psf.gaussian_kernel_1d(sigma))   # symmetric
    want = np.asarray(ref_psf.convolve_separable(*_j(img, row)))
    got = psf.convolve_separable(*_t(img, row)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("hw", [(16, 16), (16, 11), (4, 3)])
@pytest.mark.parametrize("khw", [(13, 13), (5, 9), (3, 1), (1, 1)])
def test_convolve_2d_matches_reference(hw, khw):
    img = _image(*hw)
    kern = np.random.default_rng(1).uniform(-0.2, 1.0, khw).astype(np.float32)
    want = np.asarray(ref_psf.convolve_2d(*_j(img, kern)))
    got = psf.convolve_2d(*_t(img, kern)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)
    if khw[0] > 1:   # the Pallas banded-matmul form agrees as well
        np.testing.assert_allclose(got, np.asarray(_convolve_2d_matmul(*_j(img, kern))),
                                   rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("bank", ["sep", "sep_k1", "2d", "2d_kw1", "2d_k1"])
def test_convolve_batch_matches_reference(bank):
    rng = np.random.default_rng(4)
    images = rng.normal(size=(5, 12, 10)).astype(np.float32)
    kernels = {
        "sep": psf.matching_kernel_bank(np.array([1.0, 1.3, 0.0, 1.8, 2.4]), 2.2),
        "sep_k1": rng.uniform(0.5, 1.5, (5, 1)),
        "2d": rng.uniform(-0.1, 1.0, (5, 7, 7)),
        "2d_kw1": rng.uniform(0.5, 1.5, (5, 3, 1)),   # short-circuits to k[0, 0]
        "2d_k1": rng.uniform(0.5, 1.5, (5, 1, 1)),
    }[bank].astype(np.float32)
    want = np.asarray(ref_psf.convolve_batch(*_j(images, kernels)))
    got = psf.convolve_batch(*_t(images, kernels)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)
    if bank.endswith("k1") or bank.endswith("kw1"):   # one multiply: the same bits
        assert np.array_equal(got, want)


def test_correlation_pinned_against_both_reference_conventions():
    """Symmetric rows: the port agrees with the reference's convolve_separable
    (jnp.convolve flips the row) and with its Pallas banded matmuls (which
    correlate).  Asymmetric rows: the port correlates, so it agrees with the
    Pallas form and not with jnp.convolve."""
    img = _image(16, 13, seed=2)
    sym = np.asarray(ref_psf.gaussian_kernel_1d(1.4))
    asym = np.random.default_rng(5).uniform(0.0, 1.0, 7).astype(np.float32)
    port = {k: psf.convolve_separable(*_t(img, row)).numpy()
            for k, row in (("sym", sym), ("asym", asym))}
    for key, row in (("sym", sym), ("asym", asym)):
        np.testing.assert_allclose(port[key], np.asarray(_convolve_sep_matmul(*_j(img, row))),
                                   rtol=0, atol=CONV_ATOL)
    np.testing.assert_allclose(port["sym"], np.asarray(ref_psf.convolve_separable(
        *_j(img, sym))), rtol=0, atol=CONV_ATOL)
    flipped = np.asarray(ref_psf.convolve_separable(*_j(img, asym)))
    assert np.abs(port["asym"] - flipped).max() > 1e-2
    # jnp.convolve with a row is the correlation with the reversed row.
    np.testing.assert_allclose(psf.convolve_separable(*_t(img, asym[::-1])).numpy(), flipped,
                               rtol=0, atol=CONV_ATOL)


def test_match_psf_widens_to_target_and_noop():
    """tests/test_psf.py: Gaussian(s1) * Gaussian(sqrt(s2^2 - s1^2)) = Gaussian(s2);
    no-op (the same object) when already as wide."""
    img = torch.from_numpy(psf.gaussian_stamp(1.0, 33).astype(np.float32))
    out = psf.match_psf(img, sigma_image=1.0, sigma_target=2.0)
    assert abs(float(psf.stamp_sigma(out.double().numpy())) - 2.0) < 0.1
    assert float((out - torch.from_numpy(psf.gaussian_stamp(2.0, 33))).abs().max()) < 5e-3
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_psf.match_psf(jnp.asarray(img.numpy()), 1.0, 2.0)),
        rtol=0, atol=CONV_ATOL)
    wide = torch.from_numpy(psf.gaussian_stamp(2.0, 33).astype(np.float32))
    assert psf.match_psf(wide, sigma_image=2.0, sigma_target=1.0) is wide


def test_kernel_normalized_and_flux_preserved():
    """tests/test_psf.py: unit-sum rows; convolution preserves flux."""
    k = psf.gaussian_kernel_1d(1.5)
    assert abs(float(k.sum()) - 1.0) < 1e-6
    img = torch.from_numpy(psf.gaussian_stamp(1.0, 33).astype(np.float32))
    out = psf.convolve_separable(img, psf.gaussian_kernel_1d(1.2))
    assert abs(float(out.sum()) - float(img.sum())) < 1e-4


def test_matching_kernel_bank_closure():
    """tests/test_psf.py: convolving sigma_i up to sigma_t through the bank gives
    a sigma_t PSF; a row already at the target is a no-op; nothing to widen
    is a K = 1 identity bank, and empty slots do not widen it."""
    sigmas = np.array([1.0, 1.4, 2.0], np.float32)
    bank = psf.matching_kernel_bank(sigmas, 2.0)
    np.testing.assert_allclose(bank.sum(axis=1), 1.0, atol=1e-6)
    images = torch.stack([torch.from_numpy(psf.gaussian_stamp(float(s), 33).astype(np.float32))
                          for s in sigmas])
    out = psf.convolve_batch(images, torch.from_numpy(bank))
    expected = torch.from_numpy(psf.gaussian_stamp(2.0, 33).astype(np.float32))
    for i, s in enumerate(sigmas):
        if s >= 2.0:
            torch.testing.assert_close(out[i], images[i], atol=1e-6, rtol=0)
        else:
            assert abs(float(psf.stamp_sigma(out[i].double().numpy())) - 2.0) < 0.1
            assert float((out[i] - expected).abs().max()) < 5e-3
    assert psf.matching_kernel_bank(np.array([2.0, 3.0, 0.0]), 1.5).shape == (3, 1)
    wide = psf.matching_kernel_bank(np.array([1.0, 0.0]), 2.0)
    r = (wide.shape[1] - 1) // 2
    np.testing.assert_array_equal(wide[1], (np.arange(2 * r + 1) == r).astype(np.float32))


# ----- the plain kernels against the Pallas kernels ------------------------

@pytest.fixture(scope="module")
def pack(moffat):
    """One 16-slot pack of the survey's r frames over the query (some slots
    rejected), its grids, and four banks: the Gaussian fallback and the
    measured homogenization bank at the main target, and random asymmetric
    taps of each rank."""
    sv = moffat[1]
    ids = rt.SpatialIndex.build(sv).select(rt.CoaddQuery(**QUERY))
    ids = np.resize(ids, 16)
    px = np.stack([sv.images[i].pixels for i in ids])
    wv = np.stack([sv.images[i].wcs.to_vector() for i in ids])
    acc = np.ones(len(ids), np.float32)
    acc[[1, 6]] = 0.0
    gr, gd = query_grid_sky(rt.CoaddQuery(**QUERY))
    sig = np.array([sv.images[i].psf_sigma for i in ids], np.float32)
    stamps = np.stack([sv.images[i].psf_stamp for i in ids])
    rng = np.random.default_rng(9)
    banks = {
        "sep": psf.matching_kernel_bank(sig, MAIN_TARGET),
        "2d": psf.homogenization_bank(stamps, sig, MAIN_TARGET),
        "sep_asym": rng.uniform(0.0, 0.3, (len(ids), 5)).astype(np.float32),
        "2d_asym": rng.uniform(-0.05, 0.2, (len(ids), 5, 7)).astype(np.float32),
    }
    assert banks["sep"].shape[1] == 15 and banks["2d"].shape[1:] == (13, 13)
    return dict(np=(px, wv, acc, gr, gd), banks=banks,
                scan=(*_t(px[None], wv[None]), torch.zeros(1, dtype=torch.int32),
                      *_t(acc[None], gr, gd)))


BANKS = ("sep", "2d", "sep_asym", "2d_asym")


def _fixed(pack, bank):
    """Both estimators' fixed operands from the plain moments with the bank."""
    b = torch.from_numpy(pack["banks"][bank])[None]
    s = ops.coadd_moments(*pack["scan"], psf_kernels=b)
    mu, sigma = reducer.clip_stats(*s)
    lo, w, inv_w = reducer.hist_bounds(*s, NBINS)
    med = reducer.hist_median(ops.coadd_hist(*pack["scan"], lo, inv_w, NBINS, psf_kernels=b),
                              s[0], lo, w)
    return b, s, (lo, inv_w), {"clipped": mu, "median": med}, sigma


@pytest.mark.parametrize("bank", BANKS)
def test_coadd_fused_with_bank_matches_pallas(pack, bank):
    b = pack["banks"][bank]
    c_ref, d_ref = ref_ops.coadd_fused(*_j(*pack["np"]), psf_kernels=jnp.asarray(b))
    c, d = ops.coadd_fused(*pack["scan"], psf_kernels=torch.from_numpy(b)[None])
    assert float(d.max()) >= 2
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL, rtol=RTOL)
    # Depth never depends on the convolution.
    assert torch.equal(d, ops.coadd_fused(*pack["scan"])[1])


def _decisions_only(diff, scan, **boundaries):
    """Differing pixels must all hold an accepted sample within 1e-3 px of its
    image's edge or, given ``clip``/``bins``, within ``ref.DECISION_TOL`` of
    the clip boundary or a bin edge (`ref.decision_flips`, on the matched
    scan): the reference's banded matmuls and the port's direct sums round
    the matched pixels differently by ulps, which moves only such samples."""
    near, far = ref.decision_flips(diff, *scan, **boundaries)
    assert not far.any(), f"{int(far.sum())} pixels differ away from every boundary"
    return near


@pytest.mark.parametrize("bank", BANKS)
def test_robust_passes_with_bank_match_pallas(pack, bank):
    b, s, (lo, inv_w), centers, sigma = _fixed(pack, bank)
    mscan = ops.matched_packs(*pack["scan"][:3], b) + pack["scan"][3:]
    jb = jnp.asarray(pack["banks"][bank])
    args = _j(*pack["np"])
    s_ref = ref_ops.coadd_moments(*args, psf_kernels=jb)
    np.testing.assert_array_equal(s[0].numpy(), np.asarray(s_ref[0]))   # coverage
    for a, r in zip(s, s_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)
    h_ref = np.array(ref_ops.coadd_hist(*args, *_j(lo, inv_w), nbins=NBINS, psf_kernels=jb))
    h = ops.coadd_hist(*pack["scan"], lo, inv_w, NBINS, psf_kernels=b)
    w = reducer.hist_bounds(*s, NBINS)[1]
    _decisions_only((h != torch.from_numpy(h_ref)).any(0), mscan, bins=(lo, w, inv_w, NBINS))
    assert torch.equal(h.sum(0), s[0])                  # one bin per sample
    for center in centers.values():
        thresh = reducer.clip_threshold(center, sigma, CLIP_K)
        c_ref, d_ref = ref_ops.coadd_clip(*args, *_j(center, thresh), psf_kernels=jb)
        c, d = ops.coadd_clip(*pack["scan"], center, thresh, psf_kernels=b)
        near = _decisions_only(d != torch.from_numpy(np.array(d_ref)), mscan,
                               clip=(center, thresh))
        np.testing.assert_allclose(c[~near].numpy(), np.asarray(c_ref)[~near.numpy()],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bank", BANKS)
def test_matched_scratch_scan_is_the_per_pack_scan(pack, bank):
    """The kernel path's schedule (one psf_match over the scanned packs, then
    scans of the scratch with gathered WCS and arange(G)) gives the bits of
    the plain scans that match pack by pack, on a padded sparse index."""
    px, wv, acc, gr, gd = pack["np"]
    b = pack["banks"][bank]
    pixels, wcs, banks = _t(np.stack([px, px[::-1]]), np.stack([wv, wv[::-1]]),
                            np.stack([b, b[::-1]]))
    idx = torch.tensor([1, 0, 0], dtype=torch.int32)         # last row: padding
    accept = torch.from_numpy(np.stack([acc, acc[::-1], 0 * acc]))
    g_ra, g_dec = _t(gr, gd)
    matched, wcs_g, idx_g = ops.matched_packs(pixels, wcs, idx, banks)
    assert matched.shape == (3,) + tuple(pixels.shape[1:]) and idx_g.tolist() == [0, 1, 2]
    assert torch.equal(wcs_g[0], wcs[1]) and torch.equal(matched[2], matched[1])
    assert torch.equal(matched, ref.psf_match_ref(pixels, idx, banks))
    scan = (pixels, wcs, idx, accept, g_ra, g_dec)
    m_scan = (matched, wcs_g, idx_g, accept, g_ra, g_dec)
    for a, c in zip(ref.coadd_scan_ref(*scan, psf_kernels=banks), ref.coadd_scan_ref(*m_scan)):
        assert torch.equal(a, c)
    for a, c in zip(ref.moments_scan_ref(*scan, psf_kernels=banks),
                    ref.moments_scan_ref(*m_scan)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("bank", ["sep", "2d"])
def test_map_batch_with_bank_matches_reference(pack, bank, use_kernel):
    """The unfused map stage with a bank (``mapper.map_batch(psf_kernels=)``,
    through the psf_match and warp_project wrappers with use_kernel) against
    the reference's, per image."""
    from repro.core import mapper as ref_mapper
    from repro_torch.core import mapper

    px, wv, acc, gr, gd = pack["np"]
    b = pack["banks"][bank]
    t_ref, c_ref = ref_mapper.map_batch(*_j(px, wv, acc, gr, gd), psf_kernels=jnp.asarray(b))
    t, c = mapper.map_batch(*_t(px, wv, acc, gr, gd), use_kernel=use_kernel,
                            psf_kernels=torch.from_numpy(b))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=ATOL, rtol=RTOL)
    want = ref.coadd_scan_ref(*pack["scan"], psf_kernels=torch.from_numpy(b)[None])
    assert torch.equal(c.sum(0), want[1])


def test_psf_match_ref_delta_rows_are_identity(pack):
    """Empty slots get delta rows: matching them returns their pixels exactly."""
    px = pack["np"][0]
    for k in ((15,), (13, 13)):
        delta = np.zeros(k, np.float32)
        delta[tuple(d // 2 for d in k)] = 1.0
        bank = np.broadcast_to(delta, (1, len(px)) + k).copy()
        out = ops.psf_match(*_t(px[None]), torch.zeros(1, dtype=torch.int32), *_t(bank))
        assert torch.equal(out, torch.from_numpy(px[None]))


def test_psf_match_dispatches_on_rank_and_counts_no_cpu_launch(pack):
    px = torch.from_numpy(pack["np"][0][None])
    idx = torch.zeros(1, dtype=torch.int32)
    before = (ops.psf_match_sep.launches, ops.psf_match_2d.launches)
    for name in ("sep", "2d"):
        b = torch.from_numpy(pack["banks"][name])[None]
        assert torch.equal(ops.psf_match(px, idx, b), ref.psf_match_ref(px, idx, b))
    assert (ops.psf_match_sep.launches, ops.psf_match_2d.launches) == before
    with pytest.raises(ValueError):
        ops.psf_match_sep(px, idx, torch.from_numpy(pack["banks"]["2d"])[None])


def _bad_bank(name):
    return {
        "even": lambda b: torch.ones(b.shape[:2] + (4,)),
        "too_wide": lambda b: torch.ones(b.shape[:2] + (ops.MAX_TAPS + 2,)),
        "lead": lambda b: b[:, :-1].contiguous(),
        "dtype": lambda b: b.double(),
        "rank": lambda b: b[..., None, None],
        "type": lambda b: b.numpy(),
    }[name]


@pytest.mark.parametrize("name,err", [("even", ValueError), ("too_wide", ValueError),
                                      ("lead", ValueError), ("dtype", ValueError),
                                      ("rank", ValueError), ("type", TypeError)])
def test_psf_wrappers_reject_bad_banks(pack, name, err):
    bank = torch.from_numpy(pack["banks"]["sep"])[None]
    bad = _bad_bank(name)(bank)
    with pytest.raises(err):
        ops.psf_match(pack["scan"][0], pack["scan"][2], bad)
    with pytest.raises(err):
        ops.coadd_fused(*pack["scan"], psf_kernels=bad)


def test_psf_wrappers_reject_bad_pack_idx(pack):
    bank = torch.from_numpy(pack["banks"]["2d"])[None]
    with pytest.raises(IndexError):
        ops.psf_match(pack["scan"][0], torch.ones(1, dtype=torch.int32), bank)
    with pytest.raises(ValueError):
        ops.psf_match(pack["scan"][0], torch.zeros(1, dtype=torch.int64), bank)


# ----- engine: the port against the reference's engine ----------------------

@pytest.fixture(scope="module")
def engine_pairs(moffat):
    ref_sv, port_sv = moffat
    cache = {}

    def get(use_kernel, measured):
        if (use_kernel, measured) not in cache:
            kw = dict(pack_capacity=16, use_kernel=use_kernel, match_psf_sigma=MAIN_TARGET,
                      measured_psf=measured)
            cache[use_kernel, measured] = (rc.CoaddEngine(ref_sv, **kw),
                                           rt.CoaddEngine(port_sv, device="cpu", **kw))
        return cache[use_kernel, measured]

    return get


@pytest.mark.parametrize("measured", [None, False], ids=["measured", "fallback"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("red", REDUCES)
@pytest.mark.parametrize("method", rt.METHODS)
def test_engine_matches_reference(engine_pairs, method, red, use_kernel, measured):
    ref_eng, port_eng = engine_pairs(use_kernel, measured)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # no slot clamps at 2.5
        want = ref_eng.run(rc.CoaddQuery(**QUERY), method, reduce=red)
        got = port_eng.run(rt.CoaddQuery(**QUERY), method, reduce=red)
    assert want.depth.max() >= 2
    assert got.coadd.dtype == got.depth.dtype == np.float32
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_allclose(got.coadd, want.coadd, atol=ENGINE_ATOL)
    g, w = got.stats, want.stats
    assert (g.files_considered, g.files_contributing) == (w.files_considered,
                                                          w.files_contributing)
    passes = {"mean": 1, "clipped": 2, "median": 3}[red]
    assert g.reduce_passes == passes
    assert g.dispatches == (passes + 1 if use_kernel else passes * g.packs_scanned)
    assert port_eng.psf_kernel_bank(port_eng.plan(rt.CoaddQuery(**QUERY), method).layout).ndim \
        == (3 if measured is False else 4)


@pytest.mark.parametrize("red", ("clipped", "median"))
@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
def test_engine_matches_reference_when_the_clip_fires(moffat, use_kernel, red):
    """Two runs deep a 3-sigma clip never fires; at clip_k = 0.5 it removes
    matched samples, and the decisions must agree except for samples on a
    clip or bin boundary (ROADMAP queue 3 records the one such pixel)."""
    kw = dict(pack_capacity=16, use_kernel=use_kernel, match_psf_sigma=MAIN_TARGET,
              clip_k=0.5)
    q = rt.CoaddQuery(**QUERY)
    want = rc.CoaddEngine(moffat[0], **kw).run(rc.CoaddQuery(**QUERY), "sql_structured",
                                                reduce=red)
    port = rt.CoaddEngine(moffat[1], device="cpu", **kw)
    got = port.run(q, "sql_structured", reduce=red)
    assert got.depth.sum() < port.run(q, "sql_structured").depth.sum()
    # The port's own fixed operands place the boundaries.
    dev, idx, acc = port._scan_operands(port.plan(q, "sql_structured"))
    scan = ops.matched_packs(dev.pixels, dev.wcs, idx, port._device_psf_kernels("structured")) \
        + (acc.float(), *port._grids(q))
    s = ops.coadd_moments(*scan)
    mu, sigma = reducer.clip_stats(*s)
    lo, w, inv_w = reducer.hist_bounds(*s, NBINS)
    center = (reducer.hist_median(ops.coadd_hist(*scan, lo, inv_w, NBINS), s[0], lo, w)
              if red == "median" else mu)
    diff = torch.from_numpy((got.depth != want.depth)
                            | (np.abs(got.coadd - want.coadd) > ENGINE_ATOL))
    near = _decisions_only(diff, scan, clip=(center, reducer.clip_threshold(center, sigma, 0.5)),
                           bins=(lo, w, inv_w, NBINS))
    keep = ~near.numpy()
    np.testing.assert_array_equal(got.depth[keep], want.depth[keep])
    np.testing.assert_allclose(got.coadd[keep], want.coadd[keep], atol=ENGINE_ATOL)


def test_matching_changes_coadd_not_depth(moffat, engine_pairs):
    """tests/test_psf.py: matching is a real operation on this survey, but it
    never changes coverage; kernel path and plain path agree."""
    _, port = engine_pairs(True, None)
    _, plain = engine_pairs(False, None)
    off = rt.CoaddEngine(moffat[1], pack_capacity=16, device="cpu")
    q = rt.CoaddQuery(**QUERY)
    r_k, r_p, r_off = port.run(q, "sql_structured"), plain.run(q, "sql_structured"), \
        off.run(q, "sql_structured")
    assert np.abs(r_k.coadd - r_off.coadd).max() > 1e-3
    np.testing.assert_array_equal(r_k.depth, r_off.depth)
    np.testing.assert_array_equal(r_p.depth, r_off.depth)
    np.testing.assert_allclose(r_k.coadd, r_p.coadd, atol=ENGINE_ATOL)


def test_psf_launch_schedule(engine_pairs, monkeypatch):
    """A PSF-matched kernel-path query is one psf_match, then its passes: 2,
    3 or 4 wrapper calls, whatever the pack count."""
    _, eng = engine_pairs(True, None)
    calls = []
    for name in ("psf_match", "coadd_fused", "coadd_moments", "coadd_hist", "coadd_clip"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _real=real, _name=name, **kw: (
            calls.append(_name), _real(*a, **kw))[1])
    expect = {"mean": ["psf_match", "coadd_fused"],
              "clipped": ["psf_match", "coadd_moments", "coadd_clip"],
              "median": ["psf_match", "coadd_moments", "coadd_hist", "coadd_clip"]}
    for red, names in expect.items():
        for m in rt.METHODS:
            calls.clear()
            r = eng.run(rt.CoaddQuery(**QUERY), m, reduce=red)
            assert calls == names and r.stats.dispatches == len(names)
            assert r.stats.matched_cache_builds == r.stats.matched_cache_hits == 0


def test_match_psf_sigma_accepted_measured_requires_stamps(moffat):
    no_stamps = rt.make_survey(rt.SurveyConfig(**SMALL, psf_stamps=False))
    eng = rt.CoaddEngine(no_stamps, pack_capacity=16, device="cpu", match_psf_sigma=2.0)
    assert eng.psf_kernel_bank("structured").ndim == 3     # the Gaussian fallback
    forced = rt.CoaddEngine(no_stamps, pack_capacity=16, device="cpu", match_psf_sigma=2.0,
                            measured_psf=True)
    with pytest.raises(ValueError, match="stamps"):
        forced.run(rt.CoaddQuery(**QUERY), "sql_structured")
    assert rt.CoaddEngine(moffat[1], device="cpu").psf_kernel_bank("structured") is None


# ----- tests/test_psf_parity.py on the port ---------------------------------

@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("method", rt.METHODS)
def test_measured_matches_gaussian_fallback(gaussian, method, use_kernel):
    sv = gaussian[1]
    kw = dict(pack_capacity=16, match_psf_sigma=TARGET, use_kernel=use_kernel, device="cpu")
    r_m = rt.CoaddEngine(sv, **kw).run(rt.CoaddQuery(**QUERY), method)
    r_g = rt.CoaddEngine(sv, measured_psf=False, **kw).run(rt.CoaddQuery(**QUERY), method)
    assert r_m.depth.max() > 0
    np.testing.assert_array_equal(r_m.depth, r_g.depth)
    scale = max(float(np.abs(r_g.coadd).max()), 1.0)
    assert np.abs(r_m.coadd - r_g.coadd).max() / scale < 2e-3, method


@pytest.mark.parametrize("red", REDUCES)
@pytest.mark.parametrize("method", ["sql_structured", "raw_fits_prefiltered", "raw_fits"])
def test_matched_cache_bitwise_parity(moffat, method, red):
    """Matching the layout once and caching it gives the bytes of matching
    pack by pack in every pass."""
    kw = dict(pack_capacity=16, match_psf_sigma=TARGET, use_kernel=False, device="cpu")
    eng_c = rt.CoaddEngine(moffat[1], **kw)
    eng_u = rt.CoaddEngine(moffat[1], matched_pixel_cache=False, **kw)
    r_c = eng_c.run(rt.CoaddQuery(**QUERY), method, reduce=red)
    r_u = eng_u.run(rt.CoaddQuery(**QUERY), method, reduce=red)
    np.testing.assert_array_equal(r_c.coadd, r_u.coadd)
    np.testing.assert_array_equal(r_c.depth, r_u.depth)
    assert r_c.stats.matched_cache_builds == 1 and r_u.stats.matched_cache_builds == 0


def test_matched_cache_no_per_query_upload(moffat):
    eng = rt.CoaddEngine(moffat[1], pack_capacity=16, match_psf_sigma=TARGET, use_kernel=False,
                         device="cpu")
    r1 = eng.run(rt.CoaddQuery(**QUERY), "sql_structured")
    assert r1.stats.matched_cache_builds == 1 and r1.stats.matched_cache_hits == 0
    uploads0, builds0 = eng.pack_upload_count, eng.matched_builds
    for red in REDUCES:
        r = eng.run(rt.CoaddQuery(**QUERY), "sql_structured", reduce=red)
        assert r.stats.matched_cache_hits == 1 and r.stats.matched_cache_builds == 0
    assert eng.pack_upload_count == uploads0 and eng.matched_builds == builds0
    np.testing.assert_array_equal(r1.coadd, eng.run(rt.CoaddQuery(**QUERY),
                                                    "sql_structured").coadd)


def test_stale_plan_psf_target_rejected(moffat):
    eng_a = rt.CoaddEngine(moffat[1], pack_capacity=16, match_psf_sigma=TARGET, device="cpu")
    eng_b = rt.CoaddEngine(moffat[1], pack_capacity=16, device="cpu")
    plan = eng_a.plan(rt.CoaddQuery(**QUERY), "sql_structured")
    assert plan.psf_target == TARGET
    assert eng_b.plan(rt.CoaddQuery(**QUERY), "sql_structured").psf_target is None
    with pytest.raises(ValueError, match="psf_target"):
        eng_b.execute(plan)


# ----- tests/test_psf_properties.py on the port (its seeded grids) -----------

_rng = np.random.default_rng(82)
GRID = [(float(_rng.uniform(0.8, 1.45)), float(_rng.uniform(2.0, 2.6)),
         float(_rng.uniform(-0.12, 0.12)), float(_rng.uniform(-0.12, 0.12))) for _ in range(8)]


def _apply(stamp, kernel):
    return psf.convolve_2d(*_t(np.asarray(stamp, np.float32), kernel)).double().numpy()


@pytest.mark.parametrize("sigma,target,e1,e2", GRID)
def test_flux_conserved_grid(sigma, target, e1, e2):
    bank = psf.homogenization_bank(np.asarray([_moffat(sigma, e1, e2)]), np.asarray([sigma]),
                                   target)
    np.testing.assert_allclose(bank.sum(axis=(-2, -1)), 1.0, atol=1e-5)
    out = _apply(np.full((24, 24), 3.0), bank[0])
    np.testing.assert_allclose(out.sum(), 24 * 24 * 3.0, rtol=1e-5)


@pytest.mark.parametrize("sigma,target,e1,e2", GRID)
def test_point_source_matches_target_grid(sigma, target, e1, e2):
    stamp = _moffat(sigma, e1, e2)
    bank = psf.homogenization_bank(np.asarray([stamp]), np.asarray([sigma]), target)
    out = _apply(stamp, bank[0])
    rms = float(np.sqrt(((out - psf.gaussian_stamp(target, STAMP)) ** 2).mean()))
    assert rms <= 1e-3, (rms, sigma, target, e1, e2)


@pytest.mark.parametrize("sigma,target", [(s, t) for s, t, _, _ in GRID[:5]])
def test_gaussian_closure_grid(sigma, target):
    stamp = np.asarray(render_psf_stamp(sigma, STAMP, beta=None), np.float64)
    bank2d = psf.homogenization_bank(np.asarray([stamp]), np.asarray([sigma]), target)
    bank1d = psf.matching_kernel_bank(np.asarray([sigma]), target, radius=(STAMP - 1) // 2)
    img = torch.from_numpy(psf.gaussian_stamp(sigma, 33).astype(np.float32))[None]
    out2d = psf.convolve_batch(img, torch.from_numpy(bank2d))[0]
    out1d = psf.convolve_batch(img, torch.from_numpy(bank1d))[0]
    assert float((out2d - out1d).abs().max()) < 5e-3, (sigma, target)


@pytest.mark.parametrize("sigma,e1,e2", [(s, e1, e2) for s, _, e1, e2 in GRID])
def test_monotone_clamp_grid(sigma, e1, e2):
    stamp = _moffat(sigma, e1, e2)
    with pytest.warns(RuntimeWarning, match="never deconvolves"):
        bank = psf.homogenization_bank(np.asarray([stamp]), np.asarray([sigma]),
                                       0.5 * float(psf.stamp_sigma(stamp)))
    np.testing.assert_array_equal(bank[0], psf._delta_stamp(STAMP).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bank_w = psf.homogenization_bank(np.asarray([stamp]), np.asarray([sigma]), 2.8)
    assert psf.stamp_sigma(_apply(stamp, bank_w[0])) >= psf.stamp_sigma(stamp) - 1e-6


def test_bank_matches_single_kernel():
    rng = np.random.default_rng(7)
    stamps = np.stack([_moffat(float(s), float(e1), float(e2))
                       for s, e1, e2 in rng.uniform([0.9, -0.1, -0.1], [1.4, 0.1, 0.1], (6, 3))])
    bank = psf.homogenization_bank(stamps, np.full(6, 1.2), 2.2)
    single = np.stack([psf.homogenization_kernel(st, psf.gaussian_stamp(2.2, STAMP))
                       for st in stamps]).astype(np.float32)
    np.testing.assert_array_equal(bank, single)


def test_empty_slots_get_delta_rows():
    stamp = _moffat(1.2, 0.05, -0.03)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bank = psf.homogenization_bank(np.stack([stamp, np.zeros_like(stamp), stamp]),
                                       np.asarray([1.2, 0.0, -1.0]), 2.0)
    delta = psf._delta_stamp(STAMP).astype(np.float32)
    np.testing.assert_array_equal(bank[1], delta)
    np.testing.assert_array_equal(bank[2], delta)
    assert np.abs(bank[0] - delta).max() > 1e-3


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_engine_retune_rebuilds_bank(use_kernel):
    sv = rt.make_survey(rt.SurveyConfig(n_runs=2, n_fields=3, n_sources=40, height=16,
                                        width=16))
    q = rt.CoaddQuery(band="r", ra_bounds=(37.2, 37.7), dec_bounds=(-0.5, 0.3), npix=32)
    kw = dict(pack_capacity=16, use_kernel=use_kernel, device="cpu")
    eng = rt.CoaddEngine(sv, match_psf_sigma=2.0, **kw)
    r_20 = eng.run(q, "sql_structured")
    eng.match_psf_sigma = 2.6
    r_26 = eng.run(q, "sql_structured")
    np.testing.assert_array_equal(
        r_26.coadd, rt.CoaddEngine(sv, match_psf_sigma=2.6, **kw).run(q, "sql_structured").coadd)
    assert np.abs(r_26.coadd - r_20.coadd).max() > 1e-3
    # One bank per layout on the host and the device, one matched copy.
    assert len(eng._psf_device) == 1 and len(eng._psf_banks) == 1
    assert len(eng._matched_cache) == (0 if use_kernel else 1)
    eng.measured_psf = False
    r_fb = eng.run(q, "sql_structured")
    fresh = rt.CoaddEngine(sv, match_psf_sigma=2.6, measured_psf=False, **kw)
    np.testing.assert_array_equal(r_fb.coadd, fresh.run(q, "sql_structured").coadd)
    assert np.abs(r_fb.coadd - r_26.coadd).max() > 1e-4


def test_fixed_width_2d_path_is_the_survey_stamp():
    """csrc/psf.cu compiles one width into psf_match_2d_kernel's fixed-width
    path: the survey's default stamp, the width of every measured bank."""
    from pathlib import Path
    import re

    src = (Path(ops.__file__).resolve().parents[2] / "csrc" / "psf.cu").read_text()
    fixed = re.findall(r"constexpr int kFixedKw = (\d+);", src)
    assert [int(k) for k in fixed] == [rt.SurveyConfig().psf_stamp_size]


# ----- the CUDA kernels on a card -----------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bank", BANKS)
def test_cuda_psf_kernels_match_plain(cuda, pack, bank):
    px, idx = pack["scan"][0].to(cuda), torch.tensor([0, 0], dtype=torch.int32, device=cuda)
    b = torch.from_numpy(pack["banks"][bank])[None].to(cuda)
    name = "psf_match_2d" if b.dim() == 4 else "psf_match_sep"
    before = getattr(ops, name).launches
    out = ops.psf_match(px, idx, b)
    want = ref.psf_match_ref(px, idx, b)
    torch.cuda.synchronize()
    assert getattr(ops, name).launches == before + 1
    assert torch.equal(out, want)   # the same sums in the same order: bitwise
    scan = tuple(t.to(cuda) for t in pack["scan"])
    c, d = ops.coadd_fused(*scan, psf_kernels=b)
    c_p, d_p = ref.coadd_scan_ref(*scan, psf_kernels=b)
    near, far = ref.coverage_flips(d, d_p, 16, 16, scan[1][0], scan[3][0], *scan[4:])
    assert not far.any()
    torch.testing.assert_close(c[~near], c_p[~near], atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("taps,h,w", [
    ((13, 7), 70, 101),      # Kh != Kw; neither H nor W a multiple of the 64-px tile
    ((7, 13), 101, 70),
    ((13, 13), 515, 509),    # W not a multiple of 4: no 16-byte rows
    ((13, 1), 20, 30),       # Kw == 1: one multiply by k[0, 0]
    ((15, 15), 5, 6),        # frames smaller than the kernel
])
def test_cuda_psf_match_2d_is_bitwise_plain(cuda, taps, h, w):
    rng = np.random.default_rng(16)
    px = torch.from_numpy(rng.normal(size=(2, 4, h, w)).astype(np.float32)).to(cuda)
    bank = torch.from_numpy(rng.uniform(-0.02, 0.05, (2, 4) + taps).astype(np.float32)).to(cuda)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    out = ops.psf_match_2d(px, idx, bank)
    want = ref.psf_match_ref(px, idx, bank)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k,h,w", [
    (1, 40, 64),             # one multiply
    (3, 70, 101),            # neither H nor W a multiple of the 64-px tile or of 4
    (15, 515, 509),          # the main path's Gaussian width, W not a multiple of 4
    (15, 128, 192),
    (49, 130, 66),           # MAX_TAPS
    (49, 5, 6),              # frames smaller than the kernel
])
def test_cuda_psf_match_sep_is_bitwise_plain(cuda, k, h, w):
    rng = np.random.default_rng(k + h)
    px = torch.from_numpy(rng.normal(size=(2, 4, h, w)).astype(np.float32)).to(cuda)
    bank = torch.from_numpy(rng.uniform(-0.02, 0.08, (2, 4, k)).astype(np.float32)).to(cuda)
    idx = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    out = ops.psf_match_sep(px, idx, bank)
    want = ref.psf_match_ref(px, idx, bank)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.gpu
def test_cuda_psf_engine_matches_plain(cuda, moffat):
    q = rt.CoaddQuery(**QUERY)
    eng = rt.CoaddEngine(moffat[1], pack_capacity=16, match_psf_sigma=MAIN_TARGET)
    before = ops.psf_match_2d.launches
    r_k = eng.run(q, "sql_structured", reduce="median")
    assert ops.psf_match_2d.launches == before + 1
    eng.use_kernel = False
    r_p = eng.run(q, "sql_structured", reduce="median")
    np.testing.assert_array_equal(r_k.depth, r_p.depth)
    np.testing.assert_allclose(r_k.coadd, r_p.coadd, atol=ENGINE_ATOL)
