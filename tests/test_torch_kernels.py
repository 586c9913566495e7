"""The port's warp kernel wrappers, held against the JAX package's Pallas kernels.

On CPU tensors the wrappers run the kernels' plain torch versions; those are
held against `repro.kernels.warp.ops` in interpret mode, at the tolerance the
reference holds its own kernels to (tests/test_kernels.py:30): values at
atol 2e-2 / rtol 1e-4, coverage exactly except within 1e-3 px of an image
edge.  The CUDA kernels themselves run only on a card: those tests carry the
``gpu`` marker and skip here (``python3 chip_smoke.py`` drives them at full
size).
"""
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.kernels.warp import ops as ref_ops
from repro_torch.core.mapper import query_grid_sky
from repro_torch.kernels import build
from repro_torch.kernels.warp import ops, ref

ATOL, RTOL = 2e-2, 1e-4
SURVEY = rt.make_survey(rt.SurveyConfig(n_runs=2, n_fields=3, n_sources=40,
                                        height=24, width=24))


def _operands(band, ra, dec, npix, n):
    q = rt.CoaddQuery(band=band, ra_bounds=ra, dec_bounds=dec, npix=npix)
    ids = rt.SpatialIndex.build(SURVEY).select(q)[:n]
    assert len(ids) > 0
    px = np.stack([SURVEY.images[i].pixels for i in ids])
    wv = np.stack([SURVEY.images[i].wcs.to_vector() for i in ids])
    gr, gd = query_grid_sky(q)
    return px, wv, gr, gd


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _hold(out, cov, out_ref, cov_ref, wv, acc, gr, gd):
    """Values at the kernel tolerance; coverage exactly off the image edges."""
    out_ref, cov_ref = torch.tensor(np.asarray(out_ref)), torch.tensor(np.asarray(cov_ref))
    near, far = ref.coverage_flips(cov, cov_ref, 24, 24, *_t(wv, acc, gr, gd))
    assert not far.any()
    np.testing.assert_allclose(out[~near].numpy(), out_ref[~near].numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("npix,block_rows", [(16, 8), (32, 8), (32, 16), (64, 8), (24, 8)])
def test_warp_batch_matches_pallas(npix, block_rows):
    px, wv, gr, gd = _operands("r", (37.1, 37.6), (-0.5, 0.1), npix, 6)
    acc = np.ones(len(px), np.float32)
    t_r, c_r = ref_ops.warp_batch(*map(jnp.asarray, (px, wv, acc, gr, gd)),
                                  block_rows=block_rows)
    t, c = ops.warp_batch(*_t(px, wv, acc, gr, gd))
    assert float(t.abs().max()) > 0
    for i in range(len(px)):
        _hold(t[i], c[i], np.asarray(t_r)[i], np.asarray(c_r)[i], wv[i:i + 1], acc[i:i + 1],
              gr, gd)


@pytest.mark.parametrize("npix", [32, 64])
def test_coadd_fused_matches_pallas(npix):
    px, wv, gr, gd = _operands("g", (37.0, 37.7), (-0.7, 0.3), npix, 8)
    acc = np.ones(len(px), np.float32)
    c_r, d_r = ref_ops.coadd_fused(*map(jnp.asarray, (px, wv, acc, gr, gd)))
    c, d = ops.coadd_fused(*_t(px[None], wv[None]), torch.zeros(1, dtype=torch.int32),
                           *_t(acc[None], gr, gd))
    _hold(c, d, c_r, d_r, wv, acc, gr, gd)


@pytest.mark.parametrize("seed", range(3))
def test_coadd_fused_multi_pack_matches_pallas_scan(seed):
    """Several packs, revisited and padded, with rejected slots: the reference
    scan's per-pack kernel calls summed in pack-index order."""
    rng = np.random.default_rng(seed)
    px, wv, gr, gd = _operands("r", (37.0, 37.8), (-0.6, 0.4), 40, 8)
    n = len(px) // 2 * 2
    px, wv = px[:n].reshape(2, n // 2, 24, 24), wv[:n].reshape(2, n // 2, 8)
    pack_idx = np.array([1, 0, 1], np.int32)
    acc = (rng.random((3, n // 2)) < 0.7).astype(np.float32)
    acc[2] = 0.0                                  # a padding row
    c_r = jnp.zeros(gr.shape, jnp.float32)
    d_r = jnp.zeros(gr.shape, jnp.float32)
    for g, p in enumerate(pack_idx):
        c, d = ref_ops.coadd_fused(*map(jnp.asarray, (px[p], wv[p], acc[g], gr, gd)))
        c_r, d_r = c_r + c, d_r + d
    c, d = ops.coadd_fused(*_t(px, wv, pack_idx, acc, gr, gd))
    _hold(c, d, c_r, d_r, wv[pack_idx].reshape(-1, 8), acc.reshape(-1), gr, gd)


def test_rejected_slots_give_exact_zeros():
    px, wv, gr, gd = _operands("r", (37.1, 37.6), (-0.5, 0.1), 32, 2)
    acc = np.zeros(len(px), np.float32)
    t, c = ops.warp_batch(*_t(px, wv, acc, gr, gd))
    assert not t.any() and not c.any()
    co, de = ops.coadd_fused(*_t(px[None], wv[None]), torch.zeros(1, dtype=torch.int32),
                             *_t(acc[None], gr, gd))
    assert not co.any() and not de.any()


def test_empty_slot_adds_zero_not_nan():
    px, wv, gr, gd = _operands("r", (37.1, 37.6), (-0.5, 0.1), 32, 3)
    px = np.concatenate([px, np.zeros((1, 24, 24), np.float32)])
    wv = np.concatenate([wv, np.zeros((1, 8), np.float32)])
    acc = np.ones(len(px), np.float32)
    acc[-1] = 0.0
    c, d = ops.coadd_fused(*_t(px[None], wv[None]), torch.zeros(1, dtype=torch.int32),
                           *_t(acc[None], gr, gd))
    assert torch.isfinite(c).all() and torch.isfinite(d).all()


def test_cpu_calls_do_not_count_launches():
    px, wv, gr, gd = _operands("r", (37.1, 37.6), (-0.5, 0.1), 16, 2)
    acc = np.ones(len(px), np.float32)
    before = (ops.warp_batch.launches, ops.coadd_fused.launches)
    ops.warp_batch(*_t(px, wv, acc, gr, gd))
    ops.coadd_fused(*_t(px[None], wv[None]), torch.zeros(1, dtype=torch.int32),
                    *_t(acc[None], gr, gd))
    assert (ops.warp_batch.launches, ops.coadd_fused.launches) == before


def _good():
    px, wv, gr, gd = _operands("r", (37.1, 37.6), (-0.5, 0.1), 16, 2)
    acc = np.ones((1, len(px)), np.float32)
    return dict(zip(("pixels", "wcs_vecs", "pack_idx", "accept", "grid_ra", "grid_dec"),
                    _t(px[None], wv[None], np.zeros(1, np.int32), acc, gr, gd)))


@pytest.mark.parametrize("field,bad,err", [
    ("pixels", lambda t: t.double(), ValueError),
    ("pixels", lambda t: t[0], ValueError),
    ("pixels", lambda t: t.transpose(2, 3), ValueError),
    ("wcs_vecs", lambda t: t[..., :7].contiguous(), ValueError),
    ("pack_idx", lambda t: t.long(), ValueError),
    ("pack_idx", lambda t: t + 1, IndexError),
    ("pack_idx", lambda t: t - 1, IndexError),
    ("pack_idx", lambda t: t[:0], ValueError),
    ("accept", lambda t: t.bool(), ValueError),
    ("accept", lambda t: torch.cat([t, t]), ValueError),
    ("grid_ra", lambda t: t[:, :-1].contiguous(), ValueError),
    ("grid_dec", lambda t: [t], TypeError),
])
def test_coadd_fused_rejects_bad_operands(field, bad, err):
    args = _good()
    args[field] = bad(args[field])
    with pytest.raises(err):
        ops.coadd_fused(**args)


@pytest.mark.parametrize("field,bad", [
    ("pixels", lambda t: t.half()),
    ("wcs_vecs", lambda t: t[:1]),
    ("accepts", lambda t: t[None]),
    ("grid_ra", lambda t: t.T),
])
def test_warp_batch_rejects_bad_operands(field, bad):
    a = _good()
    args = dict(pixels=a["pixels"][0], wcs_vecs=a["wcs_vecs"][0], accepts=a["accept"][0],
                grid_ra=a["grid_ra"], grid_dec=a["grid_dec"])
    args[field] = bad(args[field])
    with pytest.raises(ValueError):
        ops.warp_batch(**args)


# ----- the build: nvcc into build/kernels, keyed by the source's hash -----

def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_rebuilds_only_on_source_change(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    log = tmp_path / "calls"
    # Writes the file named after -o and records the source it compiled.
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                f'echo "$3" >> {log}\necho lib > "$2"\n'
                                'echo "ptxas info    : Used 7 registers"\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc", lambda: nvcc)
    first = build.library_path("a")
    logs = build.build_all()
    assert set(logs) == {"a", "b"} and "registers" in logs["a"]
    assert first.exists() and build.library_path("b").exists()
    assert build.build_all() == {}                       # nothing changed: no compile
    (csrc / "a.cu").write_text("// a, edited\n")
    assert build.library_path("a") != first
    assert set(build.build_all()) == {"a"}
    assert len(log.read_text().split()) == 3


def test_build_reports_compiler_failure(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "bad.cu").write_text("not cuda\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: _fake_nvcc(tmp_path, "echo 'error: nope'\nexit 2\n"))
    with pytest.raises(RuntimeError, match="nope"):
        build.build_all()
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "missing" / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_build_flags_keep_fp32_honest():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-fmad=false" in flags
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert build.CSRC.joinpath("warp.cu").exists()


# ----- the CUDA kernels on a card -----------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("npix", [16, 45, 64])
def test_cuda_kernels_match_plain(cuda, npix):
    px, wv, gr, gd = _operands("r", (37.0, 37.8), (-0.6, 0.4), npix, 8)
    acc = (np.arange(len(px)) % 3 != 0).astype(np.float32)
    px_d, wv_d, acc_d, gr_d, gd_d = (t.to(cuda) for t in _t(px, wv, acc, gr, gd))
    before = (ops.warp_batch.launches, ops.coadd_fused.launches)
    t, c = ops.warp_batch(px_d, wv_d, acc_d, gr_d, gd_d)
    t_p, c_p = ref.warp_batch_ref(px_d, wv_d, acc_d, gr_d, gd_d)
    co, de = ops.coadd_fused(px_d[None], wv_d[None],
                             torch.zeros(1, dtype=torch.int32, device=cuda),
                             acc_d[None], gr_d, gd_d)
    co_p, de_p = ref.coadd_fused_ref(px_d, wv_d, acc_d, gr_d, gd_d)
    torch.cuda.synchronize()
    assert (ops.warp_batch.launches, ops.coadd_fused.launches) == (before[0] + 1, before[1] + 1)
    for i in range(len(px)):
        near, far = ref.coverage_flips(c[i], c_p[i], 24, 24, wv_d[i:i + 1], acc_d[i:i + 1],
                                       gr_d, gd_d)
        assert not far.any()
        torch.testing.assert_close(t[i][~near], t_p[i][~near], atol=ATOL, rtol=RTOL)
    near, far = ref.coverage_flips(de, de_p, 24, 24, wv_d, acc_d, gr_d, gd_d)
    assert not far.any()
    torch.testing.assert_close(co[~near], co_p[~near], atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices(cuda):
    args = _good()
    args["grid_ra"] = args["grid_ra"].to(cuda)
    with pytest.raises(ValueError):
        ops.coadd_fused(**args)
