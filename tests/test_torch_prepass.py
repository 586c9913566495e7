"""The PSF pre-pass matches only the slots a pass reads.

On the kernel path a PSF-matched query runs ONE ``psf_match`` launch into a
(G, cap, H, W) scratch before its passes.  `ops.matched_packs`, given the
scan's accept and the scratch's flag (`ops.matched_finite`), hands that
launch a (G, cap) ``skip`` (`ops.prepass_skip`): the rejected slots whose
flag is set, which the culled pack scans never read.  Those are written as
zeros and not matched.  Held here on the CPU:

* ``ref.psf_match_ref(..., skip)`` (the kernels' plain version, which the
  wrappers run for a CPU tensor) zeros exactly the skipped frames and is
  bitwise the ungated pre-pass everywhere else, with both bank ranks;
* the passes composed with a bank (``psf_kernels=``) gate their pre-pass
  when given the slot flag, bitwise the ungated passes;
* the engine (``use_kernel=True`` on the CPU: the wrappers' plain versions,
  which read every slot of the scratch) gives bitwise the result of its
  pre-pass run ungated (``ops.psf_match`` called with ``skip=None``) for
  all six methods x three estimators, with the measured and the Gaussian
  bank; ``tests/test_torch_psf.py::test_engine_matches_reference`` holds
  the same engine against the JAX package's.

The CUDA kernels run only on a card: those tests carry the ``gpu`` marker
and skip here (``python3 chip_smoke.py`` drives them at full size).
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels.warp import ops, ref

SMALL = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
QUERY = dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32)
TARGET = 2.5
REDUCES = ("mean", "clipped", "median")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op threads
    on these small tensors only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed=3, p=3, cap=5, h=11, w=14):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(p, cap, h, w))
                            .astype(np.float32))


BANKS = {
    # (P, cap) + taps, drawn per slot: separable rows, 2-D taps, and the
    # one-multiply widths of each rank.
    "sep_k15": (15,), "sep_k5": (5,), "sep_k1": (1,),
    "2d_13x13": (13, 13), "2d_7x5": (7, 5), "2d_kw1": (3, 1),
}


def _bank(name, p=3, cap=5):
    rng = np.random.default_rng(len(name))
    return torch.from_numpy(rng.uniform(-0.05, 0.2, (p, cap) + BANKS[name]).astype(np.float32))


@pytest.mark.parametrize("name", sorted(BANKS))
def test_psf_match_ref_zeros_exactly_the_skipped_frames(name):
    pixels, bank = _frames(), _bank(name)
    idx = torch.tensor([2, 0, 2, 1], dtype=torch.int32)        # a pack scanned twice
    skip = torch.from_numpy((np.random.default_rng(1).random((4, 5)) < 0.4).astype(np.uint8))
    skip[1] = 1                                                   # a whole pack skipped
    skip[3] = 0
    full = ref.psf_match_ref(pixels, idx, bank)
    gated = ref.psf_match_ref(pixels, idx, bank, skip)
    off = skip.bool()
    assert gated.shape == full.shape and off.any() and (~off).any()
    assert torch.equal(gated[off], torch.zeros_like(gated[off]))
    assert not torch.signbit(gated[off]).any()                  # +0, as the kernels write
    assert torch.equal(gated[~off], full[~off])
    # The wrappers take the same flag (their plain version on the CPU), and
    # a flag that skips nothing is the ungated pre-pass.
    assert torch.equal(ops.psf_match(pixels, idx, bank, skip), gated)
    assert torch.equal(ops.psf_match(pixels, idx, bank, torch.zeros_like(skip)), full)
    assert torch.equal(ref.psf_match_ref(pixels, idx, bank, torch.ones_like(skip)),
                       torch.zeros_like(full))


@pytest.mark.parametrize("bad,err", [("dtype", ValueError), ("shape", ValueError),
                                     ("type", TypeError)])
def test_psf_wrappers_reject_a_bad_skip(bad, err):
    pixels, bank = _frames(), _bank("sep_k5")
    idx = torch.tensor([0, 1], dtype=torch.int32)
    skip = {"dtype": torch.zeros((2, 5), dtype=torch.bool),
            "shape": torch.zeros((3, 5), dtype=torch.uint8),
            "type": np.zeros((2, 5), np.uint8)}[bad]
    with pytest.raises(err):
        ops.psf_match(pixels, idx, bank, skip)


def test_prepass_skip_is_rejected_and_flagged():
    accept = torch.tensor([[1.0, 0.0, 0.0, 0.5], [0.0, 0.0, 1.0, 1.0]])
    flag = torch.tensor([[1, 1, 0, 0], [1, 0, 1, 0]], dtype=torch.uint8)
    assert ops.prepass_skip(accept, flag).tolist() == [[0, 1, 0, 0], [1, 0, 0, 0]]
    assert ops.prepass_skip(accept != 0, flag).dtype == torch.uint8   # a boolean gate too


def _psf_match_spy(monkeypatch, ungate=False):
    """Record each ``skip`` the pre-pass is given (through `ops.matched_packs`,
    which reaches ``psf_match`` by the module global); ``ungate`` then runs
    it with ``skip=None``, every slot matched."""
    skips = []
    real = ops.psf_match

    def spy(pixels, pack_idx, psf_kernels, skip=None, **kw):
        skips.append(skip)
        return real(pixels, pack_idx, psf_kernels, None if ungate else skip, **kw)

    monkeypatch.setattr(ops, "psf_match", spy)
    return skips


# ----- the engine: gated is bitwise ungated ---------------------------------

@pytest.fixture(scope="module")
def engines():
    sv = rt.make_survey(rt.SurveyConfig(**SMALL))
    kw = dict(pack_capacity=16, device="cpu", match_psf_sigma=TARGET)
    return {measured: rt.CoaddEngine(sv, measured_psf=measured, **kw)
            for measured in (None, False)}


@pytest.mark.parametrize("measured", [None, False], ids=["measured", "fallback"])
def test_passes_with_a_bank_gate_their_prepass(engines, measured, monkeypatch):
    """coadd_fused and the robust passes composed with a bank (``psf_kernels=``)
    match only the slots they read when given the flag, and give the
    ungated bits."""
    eng = engines[measured]
    plan = eng.plan(rt.CoaddQuery(**QUERY), "raw_fits")
    dev, idx, accept = eng._scan_operands(plan)
    bank = eng._device_psf_kernels(plan.layout)
    gr, gd = eng._plan_grids(plan)
    scan = (dev.pixels, dev.wcs, idx, accept.to(torch.float32), gr, gd)
    lo, inv_w = torch.full(gr.shape, -50.0), torch.full(gr.shape, 0.05)
    center, thresh = torch.full(gr.shape, 0.5), torch.full(gr.shape, 40.0)

    def passes(**kw):
        return (ops.coadd_fused(*scan, bank, **kw) + ops.coadd_moments(*scan, bank, **kw)
                + (ops.coadd_hist(*scan, lo, inv_w, 8, bank, **kw),)
                + ops.coadd_clip(*scan, center, thresh, bank, **kw))

    skips = _psf_match_spy(monkeypatch)
    gated = passes(finite=dev.finite)
    want = ops.prepass_skip(scan[3], ops.matched_finite(dev.finite, idx, bank))
    assert len(skips) == 4 and all(torch.equal(sk, want) for sk in skips)
    assert int(want.sum()) > 0 and int((want == 0).sum()) > 0
    ungated = passes()
    assert skips[4:] == [None] * 4 and gated[1].max() >= 2
    for a, b in zip(gated, ungated):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("measured", [None, False], ids=["measured", "fallback"])
@pytest.mark.parametrize("red", REDUCES)
@pytest.mark.parametrize("method", rt.METHODS)
def test_gated_prepass_is_bitwise_the_ungated(engines, method, red, measured, monkeypatch):
    eng = engines[measured]
    q = rt.CoaddQuery(**QUERY)
    skips = _psf_match_spy(monkeypatch)
    gated = eng.run(q, method, reduce=red)
    (skip,) = skips
    _psf_match_spy(monkeypatch, ungate=True)
    ungated = eng.run(q, method, reduce=red)
    assert gated.depth.max() >= 2
    np.testing.assert_array_equal(gated.coadd.view(np.int32), ungated.coadd.view(np.int32))
    np.testing.assert_array_equal(gated.depth.view(np.int32), ungated.depth.view(np.int32))
    # The gate did skip: every scanned slot the passes cannot read.
    dev, idx, accept = eng._scan_operands(eng.plan(q, method))
    flag = ops.matched_finite(dev.finite, idx, eng._device_psf_kernels(eng.plan(q, method).layout))
    assert torch.equal(skip, ((accept == 0) & (flag != 0)).to(torch.uint8))
    assert int(skip.sum()) > 0 and int((skip == 0).sum()) > 0


# ----- the kernels on a card ------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BANKS))
def test_cuda_gated_prepass_writes_zeros_exactly_where_skipped(cuda, name):
    pixels, bank = _frames(h=70, w=101).to(cuda), _bank(name).to(cuda)
    idx = torch.tensor([2, 0, 2, 1], dtype=torch.int32, device=cuda)
    skip = torch.from_numpy((np.random.default_rng(2).random((4, 5)) < 0.4)
                            .astype(np.uint8)).to(cuda)
    out = ops.psf_match(pixels, idx, bank, skip)
    want = ref.psf_match_ref(pixels, idx, bank, skip)
    full = ops.psf_match(pixels, idx, bank)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(out[skip == 0], full[skip == 0])


@pytest.mark.gpu
@pytest.mark.parametrize("measured", [None, False], ids=["measured", "fallback"])
def test_cuda_gated_engine_matches_plain(cuda, measured):
    sv = rt.make_survey(rt.SurveyConfig(**SMALL))
    eng = rt.CoaddEngine(sv, pack_capacity=16, match_psf_sigma=TARGET, measured_psf=measured)
    q = rt.CoaddQuery(**QUERY)
    r_k = eng.run(q, "raw_fits", reduce="median")
    eng.use_kernel = False
    r_p = eng.run(q, "raw_fits", reduce="median")
    np.testing.assert_array_equal(r_k.depth, r_p.depth)
    np.testing.assert_allclose(r_k.coadd, r_p.coadd, atol=1e-3)
