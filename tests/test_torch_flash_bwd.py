"""The flash-attention backward: its plain version and the autograd Function.

`ref.flash_bwd_ref` (the function of the three backward kernels of
``csrc/flash.cu``, densely) is held against ``torch.autograd`` through
`ref.flash_ref` and against ``jax.grad`` through the JAX package's
``repro.kernels.attention.ops.flash_attention`` (the Pallas kernel in
interpret mode forward, XLA through ``mha_ref`` backward), on the same
numpy-seeded operands: GQA 4:2 and MQA 4:1, head dims 16 and 64, S 64 and
100, causal, non-causal and window 8; float32 at atol 5e-5 / rtol 1e-4.
The Pallas kernel takes S only in multiples of its block and no window
without the causal mask: those cases are held against ``jax.grad`` through
the JAX package's ``mha_ref`` instead.  `ops.FlashAttention` passes
``torch.autograd.gradcheck`` in float64, the forward's LSE is
``logsumexp`` of the masked, scaled logits, and the wrapper keeps the
serving path (no LSE) under ``inference_mode``.  The kernels themselves run
only on a card: the ``gpu`` cases hold them against the plain version and
run them twice for the same bits.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as ref_ops
from repro.kernels.attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.attention import ops, ref

ATOL, RTOL = 5e-5, 1e-4
CASES = list(itertools.product([(4, 2), (4, 1)], [16, 64], [64, 100],
                               [(True, None), (False, None), (True, 8)]))


def _operands(hq, hkv, s, d, seed=7, b=2):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))
    return [rng.standard_normal(sh, np.float32) for sh in shapes]


def _jax_grads(q, k, v, do, causal, window):
    """jax.grad of <o, do> through the JAX package's flash call where the
    Pallas kernel takes the case, else through its mha_ref."""
    s = q.shape[2]
    if s % 64 == 0 and (causal or window is None):
        fn = lambda q, k, v: ref_ops.flash_attention(q, k, v, causal, window, 64, 64, True)  # noqa: E731
    else:
        fn = lambda q, k, v: jax_mha_ref(q, k, v, causal=causal, window=window)  # noqa: E731
    g = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in g]


@pytest.mark.parametrize("heads,d,s,mask", CASES)
def test_bwd_ref_matches_autograd_and_jax(heads, d, s, mask):
    hq, hkv = heads
    causal, window = mask
    q, k, v, do = _operands(hq, hkv, s, d)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    dot = torch.from_numpy(do)
    o, lse = ref.flash_ref(qt.detach(), kt.detach(), vt.detach(), causal, window,
                           return_lse=True)
    got = ref.flash_bwd_ref(qt.detach(), kt.detach(), vt.detach(), o, lse, dot, causal, window)
    auto = torch.autograd.grad(ref.flash_ref(qt, kt, vt, causal, window), (qt, kt, vt), dot)
    want = _jax_grads(q, k, v, do, causal, window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 3),
                                           (False, 3)])
def test_flash_function_gradcheck_float64(causal, window):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
               for shape in ((1, 4, 7, 8), (1, 2, 7, 8), (1, 2, 7, 8)))
    assert torch.autograd.gradcheck(lambda q, k, v: ops.flash_attention(q, k, v, causal, window),
                                    (q, k, v))


@pytest.mark.parametrize("heads,s,mask", [((4, 2), 64, (True, None)), ((4, 1), 100, (False, None)),
                                          ((4, 2), 100, (True, 8)), ((4, 4), 1, (True, None))])
def test_lse_is_logsumexp_of_masked_scaled_logits(heads, s, mask):
    hq, hkv = heads
    causal, window = mask
    q, k, v, _ = (torch.from_numpy(x) for x in _operands(hq, hkv, s, 16))
    o, lse = ref.flash_ref(q, k, v, causal, window, return_lse=True)
    logits = (q @ k[:, torch.arange(hq) // (hq // hkv)].transpose(-1, -2)) / 4.0
    keep = ref._mask(s, causal, window, q.device)
    want = torch.logsumexp(torch.where(keep, logits, ref.NEG_INF), dim=-1)
    assert lse.shape == (2, hq, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    assert torch.equal(o, ref.flash_ref(q, k, v, causal, window))


def test_wrapper_routes_by_grad_mode():
    q, k, v, do = (torch.from_numpy(x) for x in _operands(4, 2, 64, 16))
    with torch.inference_mode():
        assert ops.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    o = ops.flash_attention(qg, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (dq,) = torch.autograd.grad(o, qg, do)
    o_p, lse = ref.flash_ref(q, k, v, return_lse=True)
    assert torch.equal(dq, ref.flash_bwd_ref(q, k, v, o_p, lse, do)[0])


def test_bf16_gradients_keep_operand_dtypes_and_layout():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(4, 2, 65, 16))
    # the model's (B, S, H, D) activations seen as (B, H, S, D)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    o = ops.flash_attention(qs, ks, vs)
    dq, dk, dv = torch.autograd.grad(o, (qs, ks, vs), do)
    for g, t in zip((dq, dk, dv), (qs, ks, vs)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
    o_p, lse = ref.flash_ref(q, k, v, return_lse=True)
    for g, w in zip((dq, dk, dv), ref.flash_bwd_ref(q, k, v, o_p, lse, do)):
        assert torch.equal(g, w)


class _StubFlash:
    """Stands in for ``build.library("flash")``: records every entry-point call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("flash_attention_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def test_bwd_launches_pass_each_entry_point_its_signature(monkeypatch):
    """The three C entry points get, in order, their pointers, the (b, h, s)
    strides of the model's strided layout, the shapes, mask, scale, dtype
    flag, device and stream, as ``build.SIGNATURES`` declares them."""
    stub = _StubFlash()
    monkeypatch.setattr(ops.build, "library", lambda name: stub)
    monkeypatch.setattr(ops, "_check_card", lambda q, k, v: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77})())
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2).contiguous()
                   .transpose(1, 2) for x in _operands(4, 2, 40, 64))
    o, lse = torch.empty_like(q), torch.zeros((2, 4, 40))
    (dq, dk, dv, delta), calls = ops.bwd_launches(q, k, v, o, lse, do, True, 16, 0.125)
    assert list(calls) == list(ops.BWD_KERNELS) and not stub.calls
    for call in calls.values():
        call()
    assert [n for n, _ in stub.calls] == list(ops.BWD_KERNELS.values())
    act, kv = (40 * 4 * 64, 64, 4 * 64), (40 * 2 * 64, 64, 2 * 64)
    for (name, args), ptrs, strides, tail in zip(stub.calls, (
            (o, do, delta), (q, k, v, do, lse, delta, dk, dv), (q, k, v, do, lse, delta, dq)),
            (act * 2, act + kv * 2 + act + kv * 2, act + kv * 2 + act * 2),
            ((2, 4, 40, 64, 1, None, 77), (2, 4, 2, 40, 64, 1, 16, 0.125, 1, None, 77),
             (2, 4, 2, 40, 64, 1, 16, 0.125, 1, None, 77))):   # CPU stand-ins: no index
        assert len(args) == len(ops.build.SIGNATURES["flash"][name][0]), name
        assert args[:len(ptrs)] == tuple(t.data_ptr() for t in ptrs), name
        assert args[len(ptrs):len(ptrs) + len(strides)] == strides, name
        assert args[len(ptrs) + len(strides):] == tail, name
    for g, t in zip((dq, dk, dv), (q, k, v)):
        assert g.stride() == t.stride() and g.dtype == t.dtype


# ----- the CUDA kernels on a card ------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,s,d,causal,window,dtype", [
    (4, 2, 200, 64, True, None, "float32"),
    (4, 1, 129, 128, False, None, "bfloat16"),
    (4, 2, 300, 128, True, 64, "bfloat16"),
    (2, 1, 65, 256, True, None, "float32"),
    (2, 2, 1, 64, True, None, "bfloat16"),
])
def test_cuda_bwd_kernels_match_plain_and_repeat(cuda, hq, hkv, s, d, causal, window, dtype):
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(cuda, dt) for x in _operands(hq, hkv, s, d))
    o, lse = ops._forward(q, k, v, causal, window, d ** -0.5, with_lse=True)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 2 * len(ops.BWD_KERNELS)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), atol=tol * float(w.abs().max()),
                                   rtol=tol)
