"""What the culled pack scans may skip, held on the CPU.

The culled ``pack_scan_kernel`` (csrc/warp.cu) skips a rejected slot whose
``finite`` flag is set and a slot whose footprint misses a block's tile;
``chip_smoke.py`` holds it bitwise against the unculled kernel on the card.
Here: the flag from `PackedDataset.to_device` against numpy, the PSF
scratch's flag, the plain twin of the footprint test (`ref.footprint_keep`)
against brute force (no (tile, slot) pair it culls has a sample inside the
frame), and where NaNs fall on the plain path when a rejected slot holds a
non-finite pixel, against the JAX package's Pallas kernels in interpret mode.
The staging shapes of the culled scan body (`ref.staging_scans`: cap 300,
1 and 33, repeated padding rows, every slot rejected, no flag, sub-tiles
too wide to cull, a poisoned pack) are checked to be what they say here,
and held bitwise against the unculled kernel on a card.

``warp_project_kernel`` is culled by the same footprint test: every (tile,
image) pair the twin culls must be exactly +-0 in the JAX package's
``warp_project`` (interpret mode), tile and coverage.  And the PSF pre-pass
writes zeros for the rejected slots the culled passes skip
(`ops.prepass_skip`, which `ops.matched_packs` applies): a poisoned rejected
slot is still matched.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.kernels.warp import ops as ref_ops
from repro_torch.core import psf, reducer
from repro_torch.core.geometry import sky_to_pixel
from repro_torch.core.mapper import query_grid_sky
from repro_torch.core.seqfile import FINITE_LIMIT, finite_slots, pack_structured
from repro_torch.kernels.warp import ops, ref

SURVEY = rt.make_survey(rt.SurveyConfig(n_runs=2, n_fields=3, n_sources=40,
                                        height=24, width=40))
LAYOUT = pack_structured(SURVEY, 4)   # (60, 4, 24, 40), 60 empty slots


def _planted(value, at):
    px = LAYOUT.pixels.copy()
    px[at] = value
    return px


PLANTS = {
    "nan": (np.nan, (1, 2, 3, 4)),
    "inf": (np.inf, (0, 0, 0, 0)),
    "neg_inf": (-np.inf, (2, 2, 23, 39)),
    "two_70": (np.float32(2.0 ** 70), (3, 1, 10, 10)),
    "neg_two_62": (np.float32(-(2.0 ** 62)), (1, 3, 5, 5)),
    "above_two_62": (np.nextafter(np.float32(2.0 ** 62), np.float32(np.inf)), (0, 3, 0, 1)),
}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_finite_flag_matches_numpy(name):
    value, at = PLANTS[name]
    px = _planted(value, at)
    want = (np.isfinite(px) & (np.abs(px) <= 2.0 ** 62)).all(axis=(2, 3))
    got = finite_slots(torch.from_numpy(px))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    assert got.dtype == torch.uint8
    assert bool(got[at[:2]]) == (name == "neg_two_62")
    assert int(got.sum()) == px.shape[0] * px.shape[1] - (name != "neg_two_62")


def test_to_device_carries_the_flag():
    ds = type(LAYOUT)(**{**LAYOUT.__dict__, "pixels": _planted(np.nan, (2, 3, 0, 0))})
    dev = ds.to_device("cpu")
    want = np.isfinite(ds.pixels).all(axis=(2, 3)) & (np.abs(ds.pixels) <= FINITE_LIMIT).all(
        axis=(2, 3))
    np.testing.assert_array_equal(dev.finite.numpy(), want.astype(np.uint8))
    assert dev.nbytes == ds.to_device("cpu").nbytes >= dev.finite.numel()


@pytest.mark.parametrize("rank", [3, 4])
def test_matched_flag_follows_source_and_gain(rank):
    p, cap = LAYOUT.pixels.shape[:2]
    rng = np.random.default_rng(rank)
    taps = (5,) if rank == 3 else (5, 3)
    bank = rng.uniform(0.0, 0.2, (p, cap) + taps).astype(np.float32)
    bank[1, 2] *= 10.0                      # gain far above MAX_MATCH_GAIN
    bank[0, 3] = -bank[0, 3]                # |taps|: the sign does not help
    finite = np.ones((p, cap), np.uint8)
    finite[3, 1] = 0
    idx = np.array([3, 1, 1, 0], np.int32)
    got = ops.matched_finite(torch.from_numpy(finite), torch.from_numpy(idx),
                             torch.from_numpy(bank)).numpy()
    s = np.abs(bank).reshape(p, cap, -1).sum(-1)
    gain = s * s if rank == 3 else s
    want = (finite != 0) & (gain <= ops.MAX_MATCH_GAIN)
    np.testing.assert_array_equal(got, want[idx].astype(np.uint8))
    assert got.shape == (len(idx), cap) and not got[1, 2] and not got[0, 1]


# ----- the footprint test's plain twin against brute force -----------------

def _inside(wcs, grid_ra, grid_dec, h, w):
    """(S, Q, Q) bool: the plain sample of each slot lies inside its frame."""
    lead = (wcs.shape[0], 1, 1)
    sx, sy = sky_to_pixel(grid_ra, grid_dec, wcs.T.reshape(8, *lead))
    return (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)


def _tiles_with_inside(wcs, grid_ra, grid_dec, h, w):
    """(ny, nx, S) bool: some pixel of the 32 x 8 block tile samples inside."""
    q = grid_ra.shape[0]
    ny, nx = -(-q // ref.TILE_Y), -(-q // ref.TILE_X)
    out = []
    for s0 in range(0, wcs.shape[0], 8):
        ins = _inside(wcs[s0:s0 + 8], grid_ra, grid_dec, h, w)
        pad = torch.zeros((ins.shape[0], ny * ref.TILE_Y, nx * ref.TILE_X), dtype=torch.bool)
        pad[:, :q, :q] = ins
        out.append(pad.reshape(-1, ny, ref.TILE_Y, nx, ref.TILE_X).any(dim=(2, 4)))
    return torch.cat(out).permute(1, 2, 0)


CASES = {
    # (ra, dec, npix, packs or None for every pack): sparse and dense scans.
    "dense_q96": ((37.0, 37.9), (-0.9, 0.5), 96, None),
    "sparse_q200": ((37.2, 37.7), (-0.4, 0.2), 200, [1, 4, 9, 21]),
    "ragged_q997": ((37.3, 37.65), (-0.3, 0.1), 997, [3, 7]),
    "outside_q64": ((36.2, 36.9), (-0.2, 0.3), 64, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_footprint_twin_never_culls_an_inside_sample(name):
    ra, dec, npix, packs = CASES[name]
    q = rt.CoaddQuery(band="r", ra_bounds=ra, dec_bounds=dec, npix=npix)
    gr, gd = (torch.from_numpy(a) for a in query_grid_sky(q))
    packs = range(LAYOUT.n_packs) if packs is None else packs
    wcs = torch.from_numpy(LAYOUT.wcs[list(packs)].reshape(-1, 8))
    empty = ~torch.from_numpy(LAYOUT.valid[list(packs)].reshape(-1))
    assert empty.any(), "the layout must hold empty (all-zero WCS) slots"
    acc = torch.ones(wcs.shape[0])
    h, w = LAYOUT.image_hw()
    keep = ref.footprint_keep(wcs, acc, None, gr, gd, h, w)
    need = _tiles_with_inside(wcs, gr, gd, h, w)
    assert keep.shape == need.shape
    assert not (need & ~keep).any(), "a culled (tile, slot) pair samples inside its frame"
    assert keep[..., empty].all(), "an all-zero WCS is never culled"
    culled = (~keep[..., ~empty]).float().mean()
    assert culled > (0.99 if name == "outside_q64" else 0.3), float(culled)
    # A rejected slot is skipped everywhere only when its flag is set.
    acc[::3] = 0.0
    flag = torch.zeros(wcs.shape[0], dtype=torch.bool)
    flag[::2] = True
    keep_r = ref.footprint_keep(wcs, acc, flag, gr, gd, h, w)
    skipped = (acc == 0) & flag
    assert not keep_r[..., skipped].any()
    assert torch.equal(keep_r[..., ~skipped], keep[..., ~skipped])


WIDE_SKY = {
    # (center ra, center dec, npix, fov deg): where the survey's patch does
    # not reach; the 1/cos^2 stretch and RA's wrap are what is held here.
    "dec_p60": (117.0, 60.0, 150, 0.3),
    "dec_m60": (250.0, -60.0, 150, 0.3),
    "dec_p80": (45.0, 80.0, 150, 0.3),
    "dec_m80": (300.0, -80.0, 150, 0.3),
    "ra_wrap_dec0": (0.0, 0.4, 150, 0.3),
    "ra_wrap_dec70": (359.95, 70.0, 150, 0.3),
}


@pytest.mark.parametrize("name", sorted(WIDE_SKY))
def test_footprint_twin_holds_at_high_dec_and_across_ra_zero(name):
    ra_c, dec_c, npix, fov = WIDE_SKY[name]
    h, w = 24, 40
    sky = ref.scattered_frames(ra_c, dec_c, npix, fov, 96, h, w, seed=int(ra_c) + 1000)
    gr, gd, wcs = (torch.from_numpy(a) for a in sky)
    if name.startswith("ra_wrap"):
        assert float(gr.max()) > 359.0 and float(gr.min()) < 1.0
        assert float(wcs[:, 0].max()) > 359.0 and float(wcs[:, 0].min()) < 1.0
    keep = ref.footprint_keep(wcs, torch.ones(wcs.shape[0]), None, gr, gd, h, w)
    need = _tiles_with_inside(wcs, gr, gd, h, w)
    assert need.any(dim=(0, 1)).float().mean() > 0.5, "most frames must reach the grid"
    assert not (need & ~keep).any(), "a culled (tile, slot) pair samples inside its frame"
    assert (~keep).float().mean() > 0.5, float((~keep).float().mean())


def _culled_pixels(keep, q):
    """(S, Q, Q) bool: the output pixels of each slot's culled block tiles."""
    ny, nx, s = keep.shape
    tiles = (~keep).permute(2, 0, 1)[:, :, None, :, None]
    full = tiles.expand(s, ny, ref.TILE_Y, nx, ref.TILE_X).reshape(s, ny * ref.TILE_Y,
                                                                     nx * ref.TILE_X)
    return full[:, :q, :q]


def _warp_case(name):
    """(pixels, wcs, grid_ra, grid_dec, h, w) of a footprint case: the layout's
    frames over a CASES query, or frames of random pixels over a WIDE_SKY."""
    if name in CASES:
        ra, dec, npix, packs = CASES[name]
        gr, gd = query_grid_sky(rt.CoaddQuery(band="r", ra_bounds=ra, dec_bounds=dec,
                                              npix=npix))
        packs = list(range(LAYOUT.n_packs) if packs is None else packs)
        h, w = LAYOUT.image_hw()
        return (LAYOUT.pixels[packs].reshape(-1, h, w), LAYOUT.wcs[packs].reshape(-1, 8),
                gr, gd, h, w)
    ra_c, dec_c, npix, fov = WIDE_SKY[name]
    h, w = 24, 40
    gr, gd, wcs = ref.scattered_frames(ra_c, dec_c, npix, fov, 96, h, w, seed=int(ra_c) + 1000)
    px = np.random.default_rng(int(ra_c)).normal(100.0, 10.0, (96, h, w)).astype(np.float32)
    return px, wcs, gr, gd, h, w


@pytest.mark.parametrize("name", sorted(CASES) + sorted(WIDE_SKY))
def test_warp_project_is_zero_where_the_twin_culls(name):
    """What the culled warp_project writes without sampling, 0 * a with a = 1,
    is what the JAX package's warp_project gives at every pixel of every
    (tile, image) pair the twin culls."""
    px, wcs, gr, gd, h, w = _warp_case(name)
    q = gr.shape[0]
    acc = np.ones(len(px), np.float32)
    keep = ref.footprint_keep(*_t(wcs, acc), None, *_t(gr, gd), h, w)
    culled = _culled_pixels(keep, q).numpy()
    assert 0.3 < culled.mean() < 1.0, float(culled.mean())
    rows = max(b for b in range(1, 9) if q % b == 0)
    tile, cov = (np.asarray(a) for a in ref_ops.warp_batch(
        *map(jnp.asarray, (px, wcs, acc, gr, gd)), block_rows=rows))
    assert (tile[culled] == 0).all() and (cov[culled] == 0).all()
    assert cov[~culled].sum() > 0 or name == "outside_q64"   # that grid misses every frame


def test_footprint_twin_keeps_non_finite_accepts_and_wide_caps():
    q = rt.CoaddQuery(band="r", ra_bounds=(36.0, 36.5), dec_bounds=(-0.2, 0.2), npix=64)
    gr, gd = (torch.from_numpy(a) for a in query_grid_sky(q))
    wcs = torch.from_numpy(LAYOUT.wcs[0, :4].copy())
    h, w = LAYOUT.image_hw()
    acc = torch.tensor([1.0, float("nan"), float("inf"), 0.0])
    keep = ref.footprint_keep(wcs, acc, torch.ones(4, dtype=torch.bool), gr, gd, h, w)
    assert not keep[..., 0].any() and keep[..., 1:3].all() and not keep[..., 3].any()
    # A grid whose 8 x 8 sub-tiles span more than MAX_CHORD is never culled.
    coarse = rt.CoaddQuery(band="r", ra_bounds=(0.0, 60.0), dec_bounds=(-20.0, 20.0), npix=16)
    gr, gd = (torch.from_numpy(a) for a in query_grid_sky(coarse))
    assert ref.footprint_keep(wcs, torch.ones(4), None, gr, gd, h, w).all()


# ----- a non-finite pixel in a rejected slot: where the NaNs fall ----------

def _poisoned():
    """One pack of 4 frames over the query, slot 1 rejected and poisoned at a
    source pixel its footprint samples: NaN, inf and 2**70."""
    q = rt.CoaddQuery(band="r", ra_bounds=(37.0, 37.3), dec_bounds=(-0.3, 0.0), npix=48)
    gr, gd = query_grid_sky(q)
    ids = rt.SpatialIndex.build(SURVEY).select(q)[:4]
    px = np.stack([SURVEY.images[i].pixels for i in ids]).astype(np.float32)
    wv = np.stack([SURVEY.images[i].wcs.to_vector() for i in ids]).astype(np.float32)
    acc = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    sx, sy = sky_to_pixel(torch.from_numpy(gr), torch.from_numpy(gd), torch.from_numpy(wv[1]))
    inside = (sx >= 0) & (sx <= px.shape[2] - 1) & (sy >= 0) & (sy <= px.shape[1] - 1)
    ys, xs = torch.floor(sy[inside]).long(), torch.floor(sx[inside]).long()
    spots = [(int(ys[k]), int(xs[k])) for k in (0, len(ys) // 2, len(ys) - 1)]
    for (y, x), v in zip(spots, (np.nan, np.inf, np.float32(2.0 ** 70))):
        px[1, y, x] = v
    return px, wv, acc, gr, gd, spots


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_rejected_poisoned_slot_nans_are_pinned():
    px, wv, acc, gr, gd, spots = _poisoned()
    scan = _t(px[None], wv[None], np.zeros(1, np.int32), acc[None], gr, gd)
    flag = finite_slots(scan[0])
    assert flag[0].tolist() == [1, 0, 1, 1]
    c, d = ops.coadd_fused(*scan, finite=flag)
    s0, s1, s2 = ops.coadd_moments(*scan, finite=flag)
    clean = px.copy()
    clean[1] = 0.0
    c0, d0 = ops.coadd_fused(*_t(clean[None], wv[None], np.zeros(1, np.int32), acc[None],
                                 gr, gd))
    center = c0 / d0.clamp(min=1.0)
    cc, dc = ops.coadd_clip(*scan, center, torch.full(gr.shape, 1e4), finite=flag)
    # The plain path weights each tile by its accept before any sum: a NaN or
    # inf read by the rejected slot's bilinear sample (NaN * 0, or inf * a
    # zero weight) stays NaN after * 0, a 2**70 one becomes 0, and the clip's
    # select drops the NaN.  Depth never sees the rejected slot.
    _, cov = ref.warp_batch_ref(*_t(px[1:2], wv[1:2], np.ones(1, np.float32), gr, gd))
    reads = {}
    for (y, x), name in zip(spots, ("nan", "inf", "two_70")):
        one = np.zeros_like(px[1])
        one[y, x] = 1.0
        t1, _ = ref.warp_batch_ref(*_t(one[None], wv[1:2], np.ones(1, np.float32), gr, gd))
        reads[name] = (t1[0] != 0) & (cov[0] > 0)
    assert all(bool(m.any()) for m in reads.values())
    nan_c = reads["nan"] | reads["inf"]
    assert int(nan_c.sum()) == 6
    assert torch.equal(d, d0) and torch.equal(s0, d0) and torch.equal(dc, d0)
    for got in (c, s1, s2):
        assert torch.equal(torch.isnan(got), nan_c)
    assert torch.equal(c[~nan_c], c0[~nan_c]) and torch.isfinite(cc).all()
    # The JAX package's Pallas kernels on the same input: the one-hot matmul
    # gathers spread a non-finite source pixel through whole source rows and
    # columns (NaN * 0 = NaN), so more output pixels are NaN, the plain
    # path's among them; S2 also where the 2**70 pixel is squared.
    jin = tuple(map(jnp.asarray, (px, wv, acc, gr, gd)))
    c_r, d_r = (np.asarray(a) for a in ref_ops.coadd_fused(*jin))
    m_r = [np.asarray(a) for a in ref_ops.coadd_moments(*jin)]
    cl_r = [np.asarray(a) for a in ref_ops.coadd_clip(*jin, jnp.asarray(center.numpy()),
                                                       jnp.full(gr.shape, 1e4))]
    np.testing.assert_array_equal(d_r, d.numpy())
    np.testing.assert_array_equal(m_r[0], s0.numpy())
    assert (np.isnan(c_r) >= nan_c.numpy()).all() and np.isnan(c_r).sum() == 48
    np.testing.assert_array_equal(np.isnan(m_r[1]), np.isnan(c_r))
    assert (np.isnan(m_r[2]) >= (nan_c | reads["two_70"]).numpy()).all()
    assert np.isnan(m_r[2]).sum() == 56
    np.testing.assert_array_equal(np.isnan(cl_r[0]), np.isnan(c_r))
    assert not np.isnan(cl_r[1]).any()


def test_rejected_poisoned_slot_leaves_the_histogram_finite():
    """The histogram's weight a·m is 0 for a rejected slot: nothing lands."""
    px, wv, acc, gr, gd, _ = _poisoned()
    scan = _t(px[None], wv[None], np.zeros(1, np.int32), acc[None], gr, gd)
    lo = torch.zeros(gr.shape)
    inv_w = torch.full(gr.shape, 0.5)
    hist = ops.coadd_hist(*scan, lo, inv_w, 8, finite=finite_slots(scan[0]))
    clean = px.copy()
    clean[1] = 0.0
    hist0 = ops.coadd_hist(*_t(clean[None], wv[None], np.zeros(1, np.int32), acc[None], gr, gd),
                           lo, inv_w, 8)
    assert torch.isfinite(hist).all() and torch.equal(hist, hist0)


@pytest.mark.parametrize("rank", [3, 4])
def test_gated_prepass_keeps_the_poisoned_nans(rank):
    """The poisoned rejected slot's flag is clear, so the gated pre-pass still
    matches it and every pass keeps its NaNs; a clean rejected slot is
    written as zeros; every pass over the gated scratch is bitwise the pass
    over the ungated one, NaN words included."""
    px, wv, acc, gr, gd, _ = _poisoned()
    acc[3] = 0.0                                  # a clean rejected slot too
    taps = (psf.gaussian_kernel_1d(1.2).numpy() if rank == 3
            else psf.gaussian_stamp(1.2, 7).astype(np.float32))
    bank = np.broadcast_to(taps, (1, 4) + taps.shape).copy()
    pixels, wcs, idx, accept, g_ra, g_dec, banks = _t(px[None], wv[None], np.zeros(1, np.int32),
                                                      acc[None], gr, gd, bank)
    flag = ops.matched_finite(finite_slots(pixels), idx, banks)
    skip = ops.prepass_skip(accept, flag)
    assert skip[0].tolist() == [0, 0, 0, 1] and flag[0].tolist() == [1, 0, 1, 1]
    gated = ops.matched_packs(pixels, wcs, idx, banks, accept, flag)
    ungated = ops.matched_packs(pixels, wcs, idx, banks)
    assert not gated[0][0, 3].any() and ungated[0][0, 3].abs().sum() > 0
    assert torch.equal(gated[0][0, :3].view(torch.int32), ungated[0][0, :3].view(torch.int32))
    assert torch.isnan(gated[0][0, 1]).any()
    outs = []
    for scan in (gated, ungated):
        scan = scan + (accept, g_ra, g_dec)
        s = ops.coadd_moments(*scan, finite=flag)
        lo, inv_w = torch.zeros(gr.shape), torch.full(gr.shape, 0.5)
        outs.append(ops.coadd_fused(*scan, finite=flag) + s
                    + (ops.coadd_hist(*scan, lo, inv_w, 8, finite=flag),)
                    + ops.coadd_clip(*scan, s[1] / s[0].clamp(min=1.0), torch.full(gr.shape, 1e4),
                                     finite=flag))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(torch.isnan(outs[0][0]).sum()) > 6       # matching spreads the NaN


# ----- the culled kernels on a card ----------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_poisoned_scan_matches_plain_nans(cuda):
    px, wv, acc, gr, gd, _ = _poisoned()
    scan = [t.to(cuda) for t in _t(px[None], wv[None], np.zeros(1, np.int32), acc[None], gr, gd)]
    flag = finite_slots(scan[0])
    c, d = ops.coadd_fused(*scan, finite=flag)
    c_p, d_p = ref.coadd_scan_ref(*scan)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(c), torch.isnan(c_p)) and torch.equal(d, d_p)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + sorted(WIDE_SKY))
def test_cuda_warp_project_is_bitwise_its_check_form(cuda, name):
    """The culled warp_project against the unculled kernel, every word."""
    from repro_torch.kernels import build

    px, wcs, gr, gd, h, w = _warp_case(name)
    acc = np.ones(len(px), np.float32)
    acc[::5] = 0.0
    args = [t.to(cuda) for t in _t(px, wcs, acc, gr, gd)]
    tile, cov = ops.warp_batch(*args)
    want = [torch.empty_like(tile) for _ in range(2)]
    err = build.library("warp").warp_project_unculled_f32(
        *(t.data_ptr() for t in args + want), len(px), h, w, gr.shape[0], cuda.index or 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for a, b in zip((tile, cov), want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ----- the staging shapes of the culled scan body --------------------------

STAGING = ref.staging_scans()


@pytest.mark.parametrize("name", sorted(STAGING))
def test_staging_scans_have_their_shapes(name):
    """Each shape `ref.staging_scans` names is what it says, by the plain
    twin of the footprint test (the most slots a block of query 0 keeps)."""
    *arrays, flag = STAGING[name]
    px, wcs, idx, acc, gr, gd = _t(*arrays)
    k = acc.shape[0]
    assert acc.shape == (k, idx.shape[0], px.shape[1]) and gr.shape == gd.shape
    assert gr.shape == (k,) + gr.shape[1:] and gr.shape[1] == gr.shape[2]
    fin = finite_slots(px) if flag else None
    rows = idx.long()
    keep = ref.footprint_keep(wcs[rows].reshape(-1, 8), acc[0].reshape(-1),
                              None if fin is None else fin[rows].reshape(-1) != 0,
                              gr[0], gd[0], *px.shape[-2:])
    kept = keep.sum(-1)
    cap = px.shape[1]
    coadd, _ = ref.coadd_scan_ref(px, wcs, idx, acc[0], gr[0], gd[0])
    assert bool(coadd.isnan().any()) == (name == "poisoned")
    assert flag == (name != "no_flag")
    if name == "cap300":
        assert cap > 256 and kept.max() > 0
    elif name in ("cap1", "cap33"):
        assert cap == int(name[3:]) and kept.max() > 0
    elif name == "sparse_repeated":
        assert idx.tolist()[3:] == [0, 0, 0] and not acc[:, 3:].any()
    elif name == "all_rejected":
        assert not acc.any() and bool(fin.all()) and kept.max() == 0
    elif name == "wide_cap":
        assert kept.min() > 256
    elif name == "poisoned":
        bad = (fin == 0).nonzero().tolist()
        assert len(bad) == 3 and all(not acc[:, idx.tolist().index(p), s].any() for p, s in bad)


def _unculled(kind, nbins, scan, fixed, shapes):
    """The unculled check form (``pack_scan_unculled_f32``) of one query."""
    from repro_torch.kernels import build

    px, _, idx, _, gr, _ = scan
    outs = [torch.empty(s, device=px.device) for s in shapes]
    err = build.library("warp").pack_scan_unculled_f32(
        kind, nbins, *(t.data_ptr() for t in scan), *[t.data_ptr() for t in fixed],
        *[None] * (2 - len(fixed)), *[t.data_ptr() for t in outs], *[None] * (3 - len(outs)),
        idx.shape[0], *px.shape[1:], gr.shape[-1], px.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STAGING))
def test_cuda_staging_shapes_are_bitwise_the_unculled_scan(cuda, name):
    """Every culled accumulator, each query bitwise the unculled kernel, and
    each batched query bitwise its one-query launch, every word."""
    *arrays, flag = STAGING[name]
    scan = [t.to(cuda) for t in _t(*arrays)]
    fin = finite_slots(scan[0]) if flag else None
    mom = ops.coadd_moments_batch(*scan, finite=fin)
    mu, sigma = reducer.clip_stats(*mom)
    passes = [("coadd_fused", 0, 0, ()), ("coadd_moments", 1, 0, ()),
              ("coadd_clip", 2, 0, (mu, reducer.clip_threshold(mu, sigma, 3.0)))]
    passes += [("coadd_hist", 3, nb, reducer.hist_bounds(*mom, nb)[::2]) for nb in ops.HIST_BINS]
    for fn, kind, nb, fixed in passes:
        nbins = (nb,) if nb else ()
        got = getattr(ops, f"{fn}_batch")(*scan, *fixed, *nbins, finite=fin)
        got = got if isinstance(got, tuple) else (got,)
        for k in range(scan[3].shape[0]):
            one_scan = scan[:3] + [t[k] for t in scan[3:]]
            fixed_k = [t[k] for t in fixed]
            one = getattr(ops, fn)(*one_scan, *fixed_k, *nbins, finite=fin)
            one = one if isinstance(one, tuple) else (one,)
            want = _unculled(kind, nb, one_scan, fixed_k, [t.shape for t in one])
            torch.cuda.synchronize()
            for a, b, c in zip(got, one, want):
                assert torch.equal(a[k].view(torch.int32), b.view(torch.int32)), (fn, k)
                assert torch.equal(b.view(torch.int32), c.view(torch.int32)), (fn, k)


# ----- the engine hands the flag to the kernels -----------------------------

@pytest.mark.parametrize("matched", [False, True])
def test_engine_passes_the_slot_flag(matched, monkeypatch):
    """The kernel path gives each pass the resident layout's flag, or over a
    PSF scratch the flag `ops.matched_finite` derives."""
    eng = rt.CoaddEngine(SURVEY, pack_capacity=8, device="cpu",
                         match_psf_sigma=2.5 if matched else None)
    seen = []
    real = ops.coadd_fused

    def spy(*scan, finite=None, **kw):
        seen.append((scan, finite))
        return real(*scan, finite=finite, **kw)

    monkeypatch.setattr(ops, "coadd_fused", spy)
    q = rt.CoaddQuery(band="r", ra_bounds=(37.0, 37.5), dec_bounds=(-0.4, 0.2), npix=24)
    plan = eng.plan(q, "sql_structured")
    res = eng.execute(plan)
    dev, idx, _ = eng._scan_operands(plan)
    (scan, finite), = seen
    want = dev.finite
    if matched:
        want = ops.matched_finite(dev.finite, idx, eng._device_psf_kernels(plan.layout))
    assert finite is not None and torch.equal(finite, want)
    assert finite.shape == scan[0].shape[:2] and res.depth.max() > 0
