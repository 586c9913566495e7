"""The port's SSD scan wrappers, held against the JAX package's kernel and model.

On CPU tensors `ops.ssd_log` (and the ``a``-form `ops.ssd` over it) runs the
kernel's plain version, `ref.ssd_chunked_ref`.  It is held against
``repro.kernels.ssd.ops.ssd`` (the Pallas kernel in interpret mode) and
``repro``'s ``ssd_batched_ref`` with ``tests/test_kernels.py``'s sweep
cases and tolerance (atol 2e-4 * max(scale, 1)), and, in log space with
decay down to -50 a step, a ragged length and the final state, against
``repro.models.ssm._ssd_chunked(return_state=True)``.  The CUDA kernel runs
only on a card: those tests carry the ``gpu`` marker and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as ref_ops
from repro.kernels.ssd.ref import ssd_batched_ref as ref_batched
from repro.kernels.ssd.ref import ssd_scan_ref as ref_scan
from repro.models.ssm import _ssd_chunked as ref_chunked
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import ssm

SWEEP = [   # tests/test_kernels.py::test_ssd_kernel_sweep
    (128, 2, 16, 16, 32),
    (256, 3, 32, 16, 64),
    (64, 1, 8, 32, 64),
    (192, 2, 16, 16, 64),
]


def _inputs(t, h, n, p, seed=1, b=2):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, h))))) * 0.95 + 0.02
    return (a.astype(np.float32), rng.standard_normal((b, t, n), np.float32),
            rng.standard_normal((b, t, n), np.float32),
            rng.standard_normal((b, t, h, p), np.float32))


def _strong(t, h, n, p, seed=2, b=2):
    """Log-decay spread over [-50, 0]: exp(dt * A) underflows float32."""
    rng = np.random.default_rng(seed)
    log_a = -rng.uniform(0.0, 1.0, (b, t, h)) ** 4 * 50.0
    return (log_a.astype(np.float32), rng.standard_normal((b, t, n), np.float32),
            rng.standard_normal((b, t, n), np.float32),
            rng.standard_normal((b, t, h, p), np.float32))


def _atol(y_ref):
    return 2e-4 * max(float(np.abs(np.asarray(y_ref)).max()), 1.0)


@pytest.mark.parametrize("t,h,n,p,chunk", SWEEP)
def test_plain_ssd_matches_pallas_and_oracle(t, h, n, p, chunk):
    arrays = _inputs(t, h, n, p)
    y_kernel = np.asarray(ref_ops.ssd(*map(jnp.asarray, arrays), chunk=chunk))
    y_oracle = np.asarray(ref_batched(*map(jnp.asarray, arrays)))
    before = ops.ssd_log.launches
    y = ops.ssd(*map(torch.from_numpy, arrays), chunk=chunk)
    assert ops.ssd_log.launches == before   # the CPU runs the plain version
    assert y.dtype == torch.float32 and y.shape == (2, t, h, p)
    np.testing.assert_allclose(y.numpy(), y_kernel, atol=_atol(y_oracle))
    np.testing.assert_allclose(y.numpy(), y_oracle, atol=_atol(y_oracle))


@pytest.mark.parametrize("t,h,n,p,chunk", SWEEP[:2])
def test_step_scans_match_reference(t, h, n, p, chunk):
    arrays = _inputs(t, h, n, p, seed=4)
    y_r = np.asarray(ref_batched(*map(jnp.asarray, arrays)))
    y = ref.ssd_batched_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(y.numpy(), y_r, atol=_atol(y_r))
    a, B, C, x = arrays
    y1_r = np.asarray(ref_scan(*(jnp.asarray(v[0]) for v in (a[..., 0], B, C, x[..., 0, :]))))
    y1 = ref.ssd_scan_ref(*(torch.from_numpy(v[0]) for v in (a[..., 0], B, C, x[..., 0, :])))
    np.testing.assert_allclose(y1.numpy(), y1_r, atol=_atol(y1_r))


@pytest.mark.parametrize("t,chunk,n", [(100, 16, 16), (64, 64, 8), (70, 32, 32)])
def test_log_space_scan_and_state_match_model(t, chunk, n):
    arrays = _strong(t, 3, n, 16)
    y_r, s_r = ref_chunked(*map(jnp.asarray, arrays), chunk, return_state=True)
    y, s = ops.ssd_log(*map(torch.from_numpy, arrays), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=_atol(y_r))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), atol=_atol(s_r))
    y_m, s_m = ssm._ssd_chunked(*map(torch.from_numpy, arrays), chunk, return_state=True)
    torch.testing.assert_close(y_m, y, atol=0, rtol=0)
    torch.testing.assert_close(s_m, s, atol=0, rtol=0)


def test_chunk_does_not_change_the_function():
    """Chunks of 64 and 256 are the same scan (the kernel sub-tiles long chunks)."""
    arrays = [torch.from_numpy(v) for v in _strong(300, 2, 16, 16, seed=8)]
    y64, s64 = ops.ssd_log(*arrays, 64)
    y256, s256 = ops.ssd_log(*arrays, 256)
    torch.testing.assert_close(y256, y64, atol=_atol(y64.numpy()), rtol=0)
    torch.testing.assert_close(s256, s64, atol=_atol(s64.numpy()), rtol=0)


def test_bf16_operands_are_scanned_in_float32():
    la, B, C, x = (torch.from_numpy(v) for v in _strong(50, 2, 16, 16, seed=6))
    Bh, Ch, xh = (v.to(torch.bfloat16) for v in (B, C, x))
    y, s = ops.ssd_log(la, Bh, Ch, xh, 16)
    y_f, s_f = ops.ssd_log(la, Bh.float(), Ch.float(), xh.float(), 16)
    assert y.dtype == s.dtype == torch.float32
    torch.testing.assert_close(y, y_f, atol=0, rtol=0)
    torch.testing.assert_close(s, s_f, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mixed", "chunk"])
def test_wrapper_rejects_bad_operands(bad):
    la, B, C, x = (torch.from_numpy(v) for v in _strong(32, 2, 8, 16))
    chunk = 16
    if bad == "dtype":
        la = la.double()
    elif bad == "shape":
        C = C[:, :16]
    elif bad == "mixed":
        x = x.to(torch.bfloat16)
    else:
        chunk = 0
    with pytest.raises(ValueError):
        ops.ssd_log(la, B, C, x, chunk)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 40.0])
    expect = np.logaddexp(x.numpy().astype(np.float64), 0.0)
    np.testing.assert_allclose(ssm.softplus(x).numpy(), expect, rtol=1e-6)


def test_ssd_source_is_built_from_the_checkout():
    assert "ssd_scan_fwd" in build.SIGNATURES["ssd"]
    assert build.CSRC.joinpath("ssd.cu").exists()


# ----- the CUDA kernel on a card --------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,chunk,n,dtype", [(1000, 64, 64, "float32"),
                                            (300, 256, 128, "bfloat16")])
def test_cuda_ssd_matches_plain(cuda, t, chunk, n, dtype):
    la, B, C, x = (torch.from_numpy(v).to(cuda) for v in _strong(t, 4, n, 64, seed=9))
    B, C, x = (v.to(getattr(torch, dtype)) for v in (B, C, x))
    before = ops.ssd_log.launches
    y, s = ops.ssd_log(la, B, C, x, chunk)
    y_p, s_p = ref.ssd_chunked_ref(la, B, C, x, chunk)
    torch.cuda.synchronize()
    assert ops.ssd_log.launches == before + 1
    torch.testing.assert_close(y, y_p, atol=_atol(y_p.cpu().numpy()), rtol=0)
    torch.testing.assert_close(s, s_p, atol=_atol(s_p.cpu().numpy()), rtol=0)


@pytest.mark.parametrize("b,t,h,want", [(4, 2048, 64, 16), (1, 1000, 64, 2), (2, 50, 3, 1),
                                        (1, 1, 64, 1), (8, 4096, 64, 16), (64, 640, 6, 6),
                                        (4, 2112, 24, 16)])
def test_heads_per_block_fills_the_card(b, t, h, want):
    n_chunks = -(-t // ops.MAX_TILE)
    g = ops.heads_per_block(b, n_chunks, h, 132)   # an H100's SMs
    assert g == want and 1 <= g <= ops.MAX_GROUP
    assert g == 1 or b * n_chunks * -(-h // g) >= ops.BLOCKS_PER_SM * 132
