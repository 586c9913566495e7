"""The port's flash-attention wrapper, held against the JAX package's kernel.

On CPU tensors `ops.flash_attention` runs the kernel's plain version
(`ref.flash_ref`); it is held against ``repro.kernels.attention.ops.
flash_attention`` (the Pallas kernel in interpret mode) and against
``repro``'s ``mha_ref``, with ``tests/test_kernels.py``'s sweep cases and
tolerances (float32 2e-5, bfloat16 2e-2).  Cases the Pallas kernel does not
take (a sequence that is not a multiple of its block, GQA 4/1 at head dim
128, window with non-causal) hold the port against its own `mha_ref`.  The
wrapper's dispatch (bfloat16 to the tensor-core entry point, float32 to the
CUDA-core one, no other tried on an error) is held on the CPU with a stub
library.  The CUDA kernels run only on a card: those tests carry the ``gpu``
marker and skip here (``python3 chip_smoke.py`` drives them at the model's
sizes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as ref_ops
from repro.kernels.attention.ref import mha_ref as ref_mha
from repro_torch.kernels import build
from repro_torch.kernels.attention import ops, ref

SWEEP = [   # tests/test_kernels.py::test_flash_attention_sweep
    (4, 4, 128, 32, True, None, "float32"),
    (4, 2, 256, 64, True, None, "float32"),
    (8, 1, 128, 32, False, None, "float32"),
    (4, 2, 256, 64, True, 64, "float32"),
    (4, 2, 128, 64, True, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(hq, hkv, s, d, seed=42, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32),
            rng.standard_normal((b, hkv, s, d), np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, pt


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("hq,hkv,s,d,causal,window,dtype", SWEEP)
def test_plain_flash_matches_pallas_and_oracle(hq, hkv, s, d, causal, window, dtype):
    (qj, kj, vj), (q, k, v) = _both(_inputs(hq, hkv, s, d), dtype)
    o_kernel = ref_ops.flash_attention(qj, kj, vj, causal, window, 64, 64, True)
    o_oracle = ref_mha(qj, kj, vj, causal=causal, window=window)
    before = ops.flash_attention.launches
    o = ops.flash_attention(q, k, v, causal, window)
    assert ops.flash_attention.launches == before   # the CPU runs the plain version
    assert o.dtype == q.dtype and o.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(o), _f32(o_kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(o), _f32(o_oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("hq,hkv,s,d,causal,window,dtype", SWEEP)
def test_mha_ref_matches_reference_oracle(hq, hkv, s, d, causal, window, dtype):
    (qj, kj, vj), (q, k, v) = _both(_inputs(hq, hkv, s, d, seed=7), dtype)
    o_r = ref_mha(qj, kj, vj, causal=causal, window=window)
    o = ref.mha_ref(q, k, v, causal=causal, window=window)
    tol = 1e-6 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_f32(o), _f32(o_r), atol=tol, rtol=tol)


@pytest.mark.parametrize("hq,hkv,s,d,causal,window,dtype", [
    (8, 2, 200, 64, True, None, "float32"),      # GQA, ragged S
    (4, 1, 77, 128, True, 16, "float32"),        # GQA 4/1, window, D 128
    (4, 4, 1, 64, True, None, "float32"),        # one token
    (4, 2, 130, 64, False, 8, "float32"),        # window without causal
    (8, 2, 200, 64, True, 64, "bfloat16"),
])
def test_plain_flash_matches_own_oracle(hq, hkv, s, d, causal, window, dtype):
    _, (q, k, v) = _both(_inputs(hq, hkv, s, d, seed=11), dtype)
    o = ops.flash_attention(q, k, v, causal, window)
    o_r = ref.mha_ref(q, k, v, causal=causal, window=window, scale=1.0 / np.sqrt(d))
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(o), _f32(o_r), atol=tol, rtol=tol)


def test_plain_flash_reads_strided_views():
    """The model hands (B, S, H, D) activations seen as (B, H, S, D)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 2, 40, 64, seed=3))
    o = ops.flash_attention(*(t.transpose(1, 2).contiguous().transpose(1, 2)
                              for t in (q, k, v)))
    torch.testing.assert_close(o, ops.flash_attention(q, k, v), atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["heads", "shape", "dtype", "window", "rank"])
def test_wrapper_rejects_bad_operands(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 2, 16, 64))
    kwargs = {}
    if bad == "heads":
        k, v = k[:, :1].expand(2, 3, 16, 64), v[:, :1].expand(2, 3, 16, 64)
    elif bad == "shape":
        k = k[:, :, :8]
    elif bad == "dtype":
        k = k.double()
    elif bad == "window":
        kwargs["window"] = 0
    else:
        q = q[0]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kwargs)


def test_flash_source_is_built_from_the_checkout():
    entries = build.SIGNATURES["flash"]
    assert set(ops.ENTRY_POINTS.values()) <= set(entries)
    # One argument list for both dtypes' kernels.
    assert entries["flash_attention_fwd_f32"] == entries["flash_attention_fwd_bf16"]
    assert build.CSRC.joinpath("flash.cu").exists()
    assert build.library_path("flash").parent == build.BUILD_DIR


class _StubFlash:
    """Stands in for ``build.library("flash")``: records every entry-point
    call and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("flash_attention_fwd"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc

        return entry

    def error_string(self, code):
        return b"stub error"


def _stub_operands(dtype):
    """The model's (B, S, H, D) activations seen as (B, H, S, D), GQA 4/2."""
    q, k, v = (torch.from_numpy(a).to(dtype).transpose(1, 2).contiguous().transpose(1, 2)
               for a in _inputs(4, 2, 40, 64))
    return q, k, v, torch.empty_like(q)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_attention_fwd_bf16"),
                                         (torch.float32, "flash_attention_fwd_f32")])
def test_launch_calls_the_entry_point_of_its_dtype(monkeypatch, dtype, entry):
    stub = _StubFlash()
    monkeypatch.setattr(build, "library", lambda name: stub)
    q, k, v, o = _stub_operands(dtype)
    ops._launch(q, k, v, o, True, 16, 0.125, 0, 1234)
    assert [name for name, _ in stub.calls] == [entry]
    args = stub.calls[0][1]
    # q, k, v, o, then the LSE output: none on the serving path.
    assert args[:5] == tuple(t.data_ptr() for t in (q, k, v, o)) + (None,)
    # The same strides, shapes and scale whichever the dtype.
    assert args[5:17] == (40 * 4 * 64, 64, 4 * 64, 40 * 2 * 64, 64, 2 * 64,
                          40 * 2 * 64, 64, 2 * 64, 40 * 4 * 64, 64, 4 * 64)
    assert args[17:] == (2, 4, 2, 40, 64, 1, 16, 0.125, 0, 1234)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_attention_fwd_bf16"),
                                         (torch.float32, "flash_attention_fwd_f32")])
def test_launch_error_raises_and_tries_no_other_entry_point(monkeypatch, dtype, entry):
    stub = _StubFlash(rc=98)
    monkeypatch.setattr(build, "library", lambda name: stub)
    with pytest.raises(RuntimeError, match=f"{entry} launch: CUDA error 98"):
        ops._launch(*_stub_operands(dtype), False, None, 0.125, 0, 0)
    assert [name for name, _ in stub.calls] == [entry]


# ----- the CUDA kernel on a card --------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,s,d,causal,window,dtype", [
    (8, 2, 200, 64, True, None, "float32"),
    (4, 1, 1000, 128, True, 64, "bfloat16"),
    (4, 4, 1, 64, False, None, "float32"),
    # bf16 on the tensor cores at the 64-key tile's edges, D 128, D 256
    (4, 2, 1, 64, True, None, "bfloat16"),
    (4, 2, 63, 64, True, None, "bfloat16"),
    (4, 2, 65, 64, True, None, "bfloat16"),
    (4, 2, 129, 64, True, None, "bfloat16"),
    (8, 4, 200, 128, False, None, "bfloat16"),
    (4, 2, 129, 256, True, None, "bfloat16"),
])
def test_cuda_flash_matches_plain(cuda, hq, hkv, s, d, causal, window, dtype):
    _, (q, k, v) = _both(_inputs(hq, hkv, s, d, seed=5), dtype)
    q, k, v = (t.to(cuda) for t in (q, k, v))
    before = ops.flash_attention.launches
    o = ops.flash_attention(q, k, v, causal, window)
    o_p = ref.flash_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
