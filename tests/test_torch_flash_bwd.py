"""The flash-attention backward: its plain version and the autograd Function.

`ref.flash_bwd_ref` (the function of the three backward kernels of
``csrc/flash.cu``, densely) is held against ``torch.autograd`` through
`ref.flash_ref` and against ``jax.grad`` through the JAX package's
``repro.kernels.attention.ops.flash_attention`` (the Pallas kernel in
interpret mode forward, XLA through ``mha_ref`` backward), on the same
numpy-seeded operands: GQA 4:2 and MQA 4:1, head dims 16 and 64, S 64 and
100, causal, non-causal and window 8; float32 at atol 5e-5 / rtol 1e-4.
In bf16 the plain version rounds where the kernels round (P before
P^T dO, dS before dS K and dS^T Q): it is held against that computation
spelled out in numpy, and by the ratio rule against ``jax.grad`` of the
JAX package's float32 ``mha_ref`` (no farther than 1.5 times ``jax.grad``
through its bf16 ``mha_ref``, plus 2^-8).  The split grid's rule
(`ops.bwd_split`) and its reduction's plain version (`ref.dkdv_reduce_ref`)
are checked on the shapes that decide them.
The Pallas kernel takes S only in multiples of its block and no window
without the causal mask: those cases are held against ``jax.grad`` through
the JAX package's ``mha_ref`` instead.  `ops.FlashAttention` passes
``torch.autograd.gradcheck`` in float64, the forward's LSE is
``logsumexp`` of the masked, scaled logits, and the wrapper keeps the
serving path (no LSE) under ``inference_mode``.  The kernels themselves run
only on a card: ``tests/test_torch_flash_bwd_gpu.py`` (no JAX, so that a
card can collect it) holds them against the plain version.
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


def _bf16_round(x):
    """float32 -> float32 values rounded to bf16 (to nearest, ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _bf16_operands(hq, hkv, s, d):
    return [_bf16_round(x) for x in _operands(hq, hkv, s, d)]


@pytest.mark.parametrize("heads,d,s,mask", CASES)
def test_bf16_bwd_ref_rounds_p_and_ds_where_the_kernels_do(heads, d, s, mask):
    """bf16 `flash_bwd_ref` against the float32 computation spelled out in
    numpy (float64 products) with P and dS rounded to bf16 before their
    products and each gradient once at the end: at most 1 % of the values
    differ (a P or dS on a rounding tie), by at most 2^-7 of the
    gradient's scale; without those two roundings ~40 % differ."""
    hq, hkv = heads
    causal, window = mask
    q, k, v, do = _bf16_operands(hq, hkv, s, d)
    qb, kb, vb, dob = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = ref.flash_ref(qb, kb, vb, causal, window, return_lse=True)
    got = [x.float().numpy() for x in ref.flash_bwd_ref(qb, kb, vb, o, lse, dob, causal, window)]
    b, group, scale = q.shape[0], hq // hkv, 1.0 / np.sqrt(d)
    qf, dof = q.astype(np.float64), do.astype(np.float64)
    of = o.float().numpy().astype(np.float64)
    kf, vf = (np.repeat(x, group, axis=1).astype(np.float64) for x in (k, v))
    keep = ref._mask(s, causal, window, "cpu").numpy()
    logits = qf @ kf.swapaxes(-1, -2) * scale
    p = np.where(keep, np.exp(logits - lse.numpy().astype(np.float64)[..., None]), 0.0)
    ds = p * (dof @ vf.swapaxes(-1, -2) - (dof * of).sum(-1, keepdims=True))

    def grads(p_, ds_):
        dq = ds_ @ kf * scale
        dk = (ds_.swapaxes(-1, -2) @ qf).reshape(b, hkv, group, s, d).sum(2) * scale
        dv = (p_.swapaxes(-1, -2) @ dof).reshape(b, hkv, group, s, d).sum(2)
        return [_bf16_round(x.astype(np.float32)) for x in (dq, dk, dv)]

    rounded = grads(*(_bf16_round(x.astype(np.float32)).astype(np.float64) for x in (p, ds)))
    unrounded = grads(p, ds)
    for name, g, r, u in zip(("dq", "dk", "dv"), got, rounded, unrounded):
        assert np.mean(g != r) <= 0.01, name
        assert np.abs(g - r).max() <= 2.0 ** -7 * np.abs(r).max(), name
        assert np.mean(g != u) >= 0.2, name


@pytest.mark.parametrize("heads,d,s,mask", CASES)
def test_bf16_bwd_ref_ratio_rule_against_jax(heads, d, s, mask):
    """The bf16 `flash_bwd_ref` gradients' relative L2 error against
    ``jax.grad`` of the JAX package's float32 ``mha_ref`` is at most 1.5
    times that of ``jax.grad`` through its bf16 ``mha_ref``, plus 2^-8."""
    hq, hkv = heads
    causal, window = mask
    q, k, v, do = _bf16_operands(hq, hkv, s, d)
    qb, kb, vb, dob = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = ref.flash_ref(qb, kb, vb, causal, window, return_lse=True)
    got = [x.float().numpy() for x in ref.flash_bwd_ref(qb, kb, vb, o, lse, dob, causal, window)]

    def jax_grads(dtype):
        args = [jnp.asarray(x, dtype) for x in (q, k, v)]
        cot = jnp.asarray(do, dtype)
        fn = lambda q, k, v: jnp.sum(  # noqa: E731
            (jax_mha_ref(q, k, v, causal=causal, window=window) * cot).astype(jnp.float32))
        return [np.asarray(x, np.float32) for x in jax.grad(fn, argnums=(0, 1, 2))(*args)]

    want, theirs = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)

    def rel(x, w):
        return float(np.linalg.norm(x - w)) / float(np.linalg.norm(w))

    for name, g, t, w in zip(("dq", "dk", "dv"), got, theirs, want):
        assert rel(g, w) <= 1.5 * rel(t, w) + 2.0 ** -8, name


# The dkdv key tiles of csrc/flash.cu (flash_attention_bwd_key_tile): bf16
# 128 keys (64 at D 256), float32 64 (32 at D 256).
@pytest.mark.parametrize("shape,key_tile,split", [
    ((2, 12, 2, 4096), 128, True),   # qwen2 bf16 training: 2 x 2 x 32 blocks
    ((3, 12, 2, 4096), 128, True),   # 192 < 198 = 1.5 x 132
    ((4, 12, 2, 4096), 128, False),  # 256
    ((2, 12, 2, 4096), 64, False),   # its float32: 2 x 2 x 64 = 256
    ((1, 12, 2, 4096), 64, True),    # 128
    ((1, 8, 1, 2048), 32, True),     # gemma float32 D 256: 64 blocks -> 512
    ((1, 12, 2, 1000), 128, True),   # ragged S 1000: 16 -> 96
    ((1, 20, 20, 1500), 128, False),  # whisper's encoder: group 1
    ((4, 12, 2, 4096), 64, False),   # 512 blocks
    ((9, 12, 2, 4096), 128, False),  # 9 x 2 x 32 = 576
])
def test_bwd_split_rule(shape, key_tile, split):
    assert ops.bwd_split(*shape, key_tile) is split


@pytest.mark.parametrize("heads,d,s,mask", CASES[:6])
def test_dkdv_reduce_ref_sums_per_head_partials_to_the_group_gradient(heads, d, s, mask):
    """The split grid's per-q-head dK (unscaled) and dV, added by
    `ref.dkdv_reduce_ref`, are `flash_bwd_ref`'s GQA dK and dV."""
    hq, hkv = heads
    causal, window = mask
    q, k, v, do = (torch.from_numpy(x) for x in _operands(hq, hkv, s, d))
    group, scale = hq // hkv, d ** -0.5
    o, lse = ref.flash_ref(q, k, v, causal, window, return_lse=True)
    kr, vr = (x.repeat_interleave(group, dim=1) for x in (k, v))
    _, dk_h, dv_h = ref.flash_bwd_ref(q, kr, vr, o, lse, do, causal, window)
    part = torch.stack((dk_h / scale, dv_h))
    dk, dv = ref.dkdv_reduce_ref(part, hkv, scale, torch.float32)
    _, dk_w, dv_w = ref.flash_bwd_ref(q, k, v, o, lse, do, causal, window)
    torch.testing.assert_close(dk, dk_w, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dv, dv_w, atol=ATOL, rtol=RTOL)


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

    @staticmethod
    def flash_attention_bwd_key_tile(d, is_bf16):   # csrc/flash.cu's, not recorded
        return {(64, 1): 128, (128, 1): 128, (256, 1): 64, (64, 0): 64, (128, 0): 64,
                (256, 0): 32}[d, is_bf16]


def _stub_card(monkeypatch):
    stub = _StubFlash()
    monkeypatch.setattr(ops.build, "library", lambda name: stub)
    monkeypatch.setattr(ops, "_check_card", lambda q, k, v: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77})())
    return stub


def test_bwd_launches_pass_each_entry_point_its_signature(monkeypatch):
    """The four C entry points of the split grid (this shape's 2 x 2 kv
    heads of one key tile) get, in order, their pointers (dkdv and the
    reduction the float32 scratch of partials), the (b, h, s) strides of
    the model's strided layout, the shapes, mask, scale, dtype flag, device
    and stream, as ``build.SIGNATURES`` declares them."""
    stub = _stub_card(monkeypatch)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2).contiguous()
                   .transpose(1, 2) for x in _operands(4, 2, 40, 64))
    o, lse = torch.empty_like(q), torch.zeros((2, 4, 40))
    (dq, dk, dv, delta, part), calls = ops.bwd_launches(q, k, v, o, lse, do, True, 16, 0.125)
    assert part.shape == (2, 2, 4, 40, 64) and part.dtype == torch.float32
    assert list(calls) == list(ops.BWD_KERNELS) and not stub.calls
    for call in calls.values():
        call()
    assert [n for n, _ in stub.calls] == list(ops.BWD_KERNELS.values())
    act, kv = (40 * 4 * 64, 64, 4 * 64), (40 * 2 * 64, 64, 2 * 64)
    mask_tail = (2, 4, 2, 40, 64, 1, 16, 0.125, 1, None, 77)   # CPU stand-ins: no index
    for (name, args), ptrs, strides, tail in zip(stub.calls, (
            (o, do, delta), (q, k, v, do, lse, delta, dk, dv, part), (part, dk, dv),
            (q, k, v, do, lse, delta, dq)),
            (act * 2, act + kv * 2 + act + kv * 2, kv * 2, act + kv * 2 + act * 2),
            ((2, 4, 40, 64, 1, None, 77), mask_tail, (2, 4, 2, 40, 64, 0.125, 1, None, 77),
             mask_tail)):
        assert len(args) == len(ops.build.SIGNATURES["flash"][name][0]), name
        assert args[:len(ptrs)] == tuple(t.data_ptr() for t in ptrs), name
        assert args[len(ptrs):len(ptrs) + len(strides)] == strides, name
        assert args[len(ptrs) + len(strides):] == tail, name
    for g, t in zip((dq, dk, dv), (q, k, v)):
        assert g.stride() == t.stride() and g.dtype == t.dtype


@pytest.mark.parametrize("hq,hkv,b", [(4, 4, 2), (12, 2, 132)])
def test_bwd_launches_off_the_split_grid_skip_the_reduction(monkeypatch, hq, hkv, b):
    """A group of 1, or two waves of kv-head blocks (132 x 2 x one key
    tile): three launches, dkdv given no scratch (a null pointer)."""
    stub = _stub_card(monkeypatch)
    s, d = 128, 128
    q, do = (torch.empty((b, hq, s, d), dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.empty((b, hkv, s, d), dtype=torch.bfloat16) for _ in range(2))
    lse = torch.zeros((b, hq, s))
    (*_, part), calls = ops.bwd_launches(q, k, v, torch.empty_like(q), lse, do, True, None,
                                         0.125)
    assert part is None
    assert list(calls) == [kk for kk in ops.BWD_KERNELS if kk != "flash_bwd_dkdv_reduce_kernel"]
    calls["flash_bwd_dkdv_kernel"]()
    (name, args), = stub.calls
    assert name == "flash_attention_bwd_dkdv" and args[8] is None
