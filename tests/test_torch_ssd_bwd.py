"""The SSD backward: its plain version and the autograd Function.

`ref.ssd_chunked_bwd_ref` (the function of the four backward kernels of
``csrc/ssd.cu``, in their decomposition: 64-step sub-chunks, a reverse
state pass) is held, on the same numpy-seeded operands and cotangents of
y and the final state, against ``torch.autograd`` through
`ref.ssd_chunked_ref`, against ``jax.grad`` through the JAX package's
``repro.models.ssm._ssd_chunked(..., return_state=True)``, and against a
float64 step-by-step scan under autograd (the exact gradient): ragged T
(1, 50, 641), chunks 64 and 256, N 64 and 128, several heads, log-decay
down to -50 a step, no final-state cotangent; each gradient within 1e-4
of its scale.  bf16 operands by the ratio rule: every bf16 gradient no
farther from the exact one (float64, on the bf16 values) than 1.5 times
``jax.grad``'s through the JAX package's bf16 call, plus 2^-8; d log_a
(float32) within 1e-4.  `ops.SSDScan` passes ``torch.autograd.gradcheck``
in float64, and the backward's C entry points get their arguments in
``build.SIGNATURES``' order (a stub library).  The kernels' split rule
(``csrc/ssd.cu``: every product on the TF32 tensor cores as 3xTF32, a value
read from bf16 exact) is emulated in numpy on each product of one
sub-chunk at Zamba2's and mamba2-130m's shapes and held within a tenth of
the kernels' 1e-4 of the float64 product's scale.  The kernels themselves run
only on a card: ``tests/test_torch_ssd_bwd_gpu.py`` (no JAX, so that a
card can collect it) holds them against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import ops, ref

REL = 1e-4
BF16_L2, BF16_ULP = 1.5, 2.0 ** -8
NAMES = ("dlog_a", "dB", "dC", "dx")
L, P = ops.MAX_TILE, ops.HEAD_DIM


def _operands(b, t, h, n, p, decay, final, seed):
    """log_a (uniform**4 times -decay), B, C, x, dy and the final state's
    cotangent (None: zero, as in training)."""
    rng = np.random.default_rng(seed)
    log_a = (-rng.uniform(0.0, 1.0, (b, t, h)) ** 4 * decay).astype(np.float32)
    arrays = [log_a] + [rng.standard_normal(s, np.float32)
                        for s in ((b, t, n), (b, t, n), (b, t, h, p), (b, t, h, p))]
    ds = rng.standard_normal((b, h, n, p), np.float32) if final else None
    return arrays, ds


def _exact(log_a, Bm, Cm, x, dy, ds):
    """The gradients by autograd through the step-by-step scan in float64."""
    ins = [torch.from_numpy(np.asarray(v, np.float64)).requires_grad_()
           for v in (log_a, Bm, Cm, x)]
    la, B, C, xx = ins
    b, t, h = la.shape
    S = torch.zeros((b, h, B.shape[-1], xx.shape[-1]), dtype=torch.float64)
    ys = []
    for i in range(t):
        S = torch.exp(la[:, i])[:, :, None, None] * S + B[:, i, None, :, None] * xx[:, i, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, i], S))
    loss = (torch.stack(ys, 1) * torch.from_numpy(np.asarray(dy, np.float64))).sum()
    if ds is not None:
        loss = loss + (S * torch.from_numpy(np.asarray(ds, np.float64))).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ins)]


def _jax(arrays, dy, ds, chunk):
    def f(*ops_in):
        y, state = jax_ssd_chunked(*ops_in, chunk, return_state=True)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(state * ds)
    return [np.asarray(g, np.float64) for g in jax.grad(f, argnums=(0, 1, 2, 3))(*arrays)]


def _autograd(arrays, dy, ds, chunk):
    ins = [torch.from_numpy(v).requires_grad_() for v in arrays]
    y, state = ref.ssd_chunked_ref(*ins, chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if ds is not None:
        loss = loss + (state * torch.from_numpy(ds)).sum()
    return [g.double().numpy() for g in torch.autograd.grad(loss, ins)]


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("t,h,n,p,chunk,decay,final", [
    (1, 3, 64, 16, 64, 50.0, True),
    (50, 3, 64, 16, 64, 50.0, True),
    (641, 3, 64, 16, 256, 50.0, True),
    (641, 2, 128, 16, 64, 50.0, False),
    (50, 4, 128, 16, 256, 1.0, False),
    (300, 2, 64, 64, 256, 5.0, True),
])
def test_plain_bwd_matches_autograd_jax_and_the_exact_gradient(t, h, n, p, chunk, decay, final):
    arrays, ds = _operands(2, t, h, n, p, decay, final, seed=t + n)
    ops_in, dy = arrays[:4], arrays[4]
    got = ref.ssd_chunked_bwd_ref(*map(torch.from_numpy, arrays),
                                  None if ds is None else torch.from_numpy(ds), chunk)
    exact = _exact(*ops_in, dy, ds)
    for name, g, a, j, e in zip(NAMES, got, _autograd(ops_in, dy, ds, chunk),
                                _jax(ops_in, dy, ds, chunk), exact):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), e) <= REL, (name, _rel(g.numpy(), e))
        assert _rel(g.numpy(), a) <= REL, (name, "autograd", _rel(g.numpy(), a))
        assert _rel(g.numpy(), j) <= REL, (name, "jax", _rel(g.numpy(), j))


@pytest.mark.parametrize("t,n,chunk", [(50, 64, 64), (641, 128, 256)])
def test_bf16_operands_by_the_ratio_rule(t, n, chunk):
    """B, C and x in bf16: the plain version computes in float32 from their
    bf16 values and rounds dB, dC and dx to bf16 once."""
    arrays, ds = _operands(2, t, 3, n, 16, 50.0, True, seed=t)
    la, dy = arrays[0], arrays[4]
    half = [torch.from_numpy(v).to(torch.bfloat16) for v in arrays[1:4]]
    got = ref.ssd_chunked_bwd_ref(torch.from_numpy(la), *half, torch.from_numpy(dy),
                                  torch.from_numpy(ds), chunk)
    values = [v.float().numpy() for v in half]
    exact = _exact(la, *values, dy, ds)
    theirs = _jax([la] + [jnp.asarray(v, jnp.bfloat16) for v in values], dy, ds, chunk)
    assert got[0].dtype == torch.float32 and _rel(got[0].numpy(), exact[0]) <= REL
    for name, g, j, e in zip(NAMES[1:], got[1:], theirs[1:], exact[1:]):
        assert g.dtype == torch.bfloat16, name
        mine = np.linalg.norm(g.double().numpy() - e) / np.linalg.norm(e)
        jax_l2 = np.linalg.norm(j - e) / np.linalg.norm(e)
        assert mine <= BF16_L2 * jax_l2 + BF16_ULP, (name, mine, jax_l2)


def test_chunks_of_64_and_256_give_the_same_bits():
    """The backward works in the kernels' 64-step sub-chunks whatever the
    chunk (the SSD identity).  On one torch thread: how the intra-op
    threads split a reduction is not part of the function."""
    arrays, ds = _operands(2, 300, 2, 64, 16, 50.0, True, seed=5)
    ts = [torch.from_numpy(v) for v in arrays]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = ref.ssd_chunked_bwd_ref(*ts, torch.from_numpy(ds), 64)
        b = ref.ssd_chunked_bwd_ref(*ts, torch.from_numpy(ds), 256)
    finally:
        torch.set_num_threads(n)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ssd_scan_gradcheck_float64():
    gen = torch.Generator().manual_seed(4)
    la = (-torch.rand((1, 11, 2), generator=gen, dtype=torch.float64) * 2).requires_grad_()
    Bm, Cm = (torch.randn((1, 11, 3), generator=gen, dtype=torch.float64, requires_grad=True)
              for _ in range(2))
    x = torch.randn((1, 11, 2, 2), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: ops.SSDScan.apply(*a, 4, "float32"),
                                     (la, Bm, Cm, x))


def test_ssd_log_bwd_on_cpu_is_the_plain_version():
    """On the CPU the backward is autograd through `ref.ssd_chunked_ref`
    (bitwise), which `ref.ssd_chunked_bwd_ref` matches within 1e-4 of each
    gradient's scale; no kernel is counted."""
    arrays, ds = _operands(1, 70, 2, 64, 16, 5.0, False, seed=9)
    ts = [torch.from_numpy(v) for v in arrays]
    before = ops.ssd_log_bwd.launches, dict(ops.ssd_log_bwd.kernel_launches)
    got = ops.ssd_log_bwd(*ts, None, 64)
    assert (ops.ssd_log_bwd.launches, ops.ssd_log_bwd.kernel_launches) == before
    ins = [t.clone().requires_grad_() for t in ts[:4]]
    y, _ = ref.ssd_chunked_ref(*ins, 64)
    want = torch.autograd.grad(y, ins, ts[4])
    for g, w, p in zip(got, want, ref.ssd_chunked_bwd_ref(*ts, None, 64)):
        assert torch.equal(g, w)
        torch.testing.assert_close(p, g, atol=REL * float(g.abs().max()), rtol=0)


def test_bf16_intra_dtype_under_grad_differentiates_the_plain_form():
    """The kernels compute in float32 only; on the CPU a bf16 intra-chunk
    form is differentiated by autograd through `ref.ssd_chunked_ref`."""
    arrays, _ = _operands(1, 40, 2, 16, 8, 5.0, False, seed=11)
    ins = [torch.from_numpy(v).requires_grad_() for v in arrays[:4]]
    y, state = ops.ssd_log(*ins, 16, "bfloat16")
    got = torch.autograd.grad(y.sum() + state.sum(), ins)
    y_r, state_r = ref.ssd_chunked_ref(*ins, 16, "bfloat16")
    want = torch.autograd.grad(y_r.sum() + state_r.sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _tf32(v):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties away
    from zero (on the magnitude bits of the sign-magnitude encoding)."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v, exact):
    """(hi, lo) TF32 parts of a float32 operand; lo = 0 for a value read from
    bf16, which TF32 holds exactly."""
    v = np.asarray(v, np.float32)
    hi = _tf32(v)
    if exact:
        assert np.array_equal(hi, v)
        return hi, np.zeros_like(v)
    return hi, _tf32(v - hi)   # v - hi is exact in float32


def _mma_3xtf32(a, b, exact_a, exact_b, passes=3):
    """a (M, K) @ b (K, N) as the kernels run it: m16n8k8 steps over K in
    order, each adding lo.hi, hi.lo and hi.hi (a pass skipped where its lo
    is 0) into a float32 accumulator; an mma's 8 products summed exactly,
    then rounded.  passes=1: hi.hi alone (one TF32 pass)."""
    (ah, al), (bh, bl) = _split(a, exact_a), _split(b, exact_b)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in terms:
            part = x[:, k:k + 8].astype(np.float64) @ y[k:k + 8].astype(np.float64)
            acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def _sub_chunk(n, dtype, seed, heads=4):
    """One 64-step sub-chunk's operands as the kernels hold them (float32
    arrays; B, C and x rounded to bf16 first in the bf16 form): per head
    the decays from log_a down to -50 a step, dy, S and dS' (float32), and
    the products' float32 inputs: G, A = M o G, W = M o D and their sum
    over the head group, e o dy."""
    rng = np.random.default_rng(seed)

    def operand(*shape):
        v = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(v).to(torch.bfloat16).float().numpy() if dtype == "bfloat16" else v

    Bm, Cm = operand(L, n), operand(L, n)
    idx = np.arange(L)
    causal = idx[None, :] <= idx[:, None]
    g = (Cm.astype(np.float64) @ Bm.T.astype(np.float64)).astype(np.float32)
    heads_ops, wsum = [], np.zeros((L, L), np.float32)
    for _ in range(heads):
        cum = np.cumsum(-rng.uniform(0.0, 1.0, L) ** 4 * 50.0).astype(np.float32)
        x, dy = operand(L, P), rng.standard_normal((L, P)).astype(np.float32)
        s_in, ds_out = (rng.standard_normal((n, P)).astype(np.float32) for _ in range(2))
        m = np.where(causal, np.exp(np.where(causal, cum[:, None] - cum[None, :], 0.0)),
                     0.0).astype(np.float32)
        d = (dy.astype(np.float64) @ x.T.astype(np.float64)).astype(np.float32)
        w = (m * d).astype(np.float32)
        wsum = (wsum + w).astype(np.float32)
        e_dy = (np.exp(cum)[:, None].astype(np.float32) * dy).astype(np.float32)
        heads_ops.append(dict(x=x, dy=dy, s_in=s_in, ds_out=ds_out, a=(m * g).astype(np.float32),
                              e_dy=e_dy))
    return Bm, Cm, heads_ops[0], wsum


# Every product the backward kernels run: (A operand, B operand, A read from
# bf16, B read from bf16) of one sub-chunk, as ``csrc/ssd.cu`` forms them.
BWD_PRODUCTS = {
    "G = C B^T": lambda B, C, o, ws: (C, B.T, True, True),
    "D = dy x^T": lambda B, C, o, ws: (o["dy"], o["x"].T, False, True),
    "A^T dy": lambda B, C, o, ws: (o["a"].T, o["dy"], False, False),
    "dy S^T": lambda B, C, o, ws: (o["dy"], o["s_in"].T, False, False),
    "x dS'^T": lambda B, C, o, ws: (o["x"], o["ds_out"].T, True, False),
    "B dS'": lambda B, C, o, ws: (B, o["ds_out"], True, False),
    "(sum W) B": lambda B, C, o, ws: (ws, B, False, True),
    "(sum W)^T C": lambda B, C, o, ws: (ws.T, C, False, True),
    "chunk sums C^T (e o dy)": lambda B, C, o, ws: (C.T, o["e_dy"], True, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("product", list(BWD_PRODUCTS))
def test_3xtf32_split_holds_each_product_at_float32_accuracy(product, n, dtype):
    """Each product of the backward kernels, emulated with their split rule
    (3xTF32; no lo part for a value read from bf16), within REL / 10 of its
    scale against the float64 product of the same float32 operands, at
    Zamba2's (N 64) and mamba2-130m's (N 128) state size: the split keeps
    the kernels' limits unchanged.  A single TF32 pass over a float32
    operand would not (it rounds at 2^-11)."""
    Bm, Cm, head, wsum = _sub_chunk(n, dtype, seed=n + len(product))
    a, b, exact_a, exact_b = BWD_PRODUCTS[product](Bm, Cm, head, wsum)
    exact_a = exact_a and dtype == "bfloat16"
    exact_b = exact_b and dtype == "bfloat16"
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(want).max())
    got = _mma_3xtf32(a, b, exact_a, exact_b)
    assert float(np.abs(got - want).max()) <= REL / 10 * scale, product
    if not (exact_a and exact_b):
        one = _mma_3xtf32(a, b, exact_a, exact_b, passes=1)
        assert float(np.abs(one - want).max()) > REL / 10 * scale, product


class _StubSSD:
    """Stands in for ``build.library("ssd")``: records every entry-point call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ssd_bwd_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("b,t,h,want", [
    (2, 4096, 64, 16),    # Zamba2's training shape: 512 blocks
    (2, 4096, 24, 16),    # mamba2-130m's: 256
    (1, 1000, 64, 4),     # a 1 x 1000 call: 16 sub-chunks, 256 blocks
    (1, 64, 3, 1),        # one sub-chunk: every head its own block, still short
])
def test_bwd_head_group_gives_each_sm_a_block(b, t, h, want):
    """The backward's chunk scan groups heads by the forward's rule with
    `BWD_BLOCKS_PER_SM` (one block an SM to aim for, where the forward aims
    for two): the largest power-of-two group that still launches a block
    for each of an H100's 132 SMs."""
    nc = -(-t // ops.MAX_TILE)
    g = ops.heads_per_block(b, nc, h, 132, ops.BWD_BLOCKS_PER_SM)
    assert g == want
    assert g == 1 or b * nc * -(-h // g) >= ops.BWD_BLOCKS_PER_SM * 132


@pytest.mark.parametrize("final", [True, False])
def test_bwd_launches_pass_each_entry_point_its_signature(monkeypatch, final):
    """The three C entry points get, in order, their pointers (the state
    pass C, dy, the decays, a null final-state gradient without one, and
    the dS' scratch it fills), B's, C's and x's element strides of the
    model's strided layout, the shapes, the sub-chunk, the head group, the
    dtype flag, device and stream, as ``build.SIGNATURES`` declares them;
    nothing launches before a call."""
    stub = _StubSSD()
    monkeypatch.setattr(ops.build, "library", lambda name: stub)
    monkeypatch.setattr(ops, "_check_card", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132})())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77})())
    b, t, h, n = 4, 2112, 20, 64
    xbc = torch.zeros((b, t, h * 64 + 2 * n), dtype=torch.bfloat16)
    x = xbc[..., :h * 64].reshape(b, t, h, 64)
    Bm, Cm = xbc[..., h * 64:h * 64 + n], xbc[..., h * 64 + n:]
    la = torch.zeros((b, t, h))
    dy = torch.zeros((b, t, h, 64))
    ds = torch.zeros((b, h, n, 64)) if final else None
    nc = t // 64
    scratch = (torch.zeros((b, nc, h, n, 64)), torch.zeros((b, nc, h, 64)))
    (dla, dB, dC, dx, ds_out, part), calls = ops.bwd_launches(la, Bm, Cm, x, dy, ds, 64,
                                                              scratch)
    group = ops.heads_per_block(b, nc, h, 132, ops.BWD_BLOCKS_PER_SM)
    assert group == 16 and part.shape == (2, b, nc, 2, 64, n)
    assert (dla.dtype, dB.dtype, dC.dtype, dx.dtype) == (torch.float32,) + (torch.bfloat16,) * 3
    assert list(calls) == list(ops.BWD_KERNELS) and not stub.calls
    assert len(calls) == 3
    for call in calls.values():
        call()
    assert [name for name, _ in stub.calls] == list(ops.BWD_KERNELS.values())
    row = h * 64 + 2 * n
    tail = (1, None, 77)   # bf16; a CPU stand-in has no device index
    for (name, args), ptrs, rest in zip(stub.calls, (
            (Cm, dy, scratch[1], ds, ds_out), (
                Bm, Cm, x, dy, scratch[0], ds_out, scratch[1], dla, dx, part),
            (part, dB, dC)), (
            (t * row, row, b, h, t, n, 64) + tail,
            (t * row, row, t * row, row, t * row, row, 64, b, h, t, n, 64, group) + tail,
            (b, t, n, 64, 2) + tail)):
        assert len(args) == len(ops.build.SIGNATURES["ssd"][name][0]), name
        assert args[:len(ptrs)] == tuple(None if v is None else v.data_ptr() for v in ptrs), name
        assert args[len(ptrs):] == rest, name


def test_copied_operands_get_16_byte_aligned_rows(monkeypatch):
    """The state pass copies C's rows, the chunk scan x's, by 16 bytes: the
    model's views go as they are, a view whose rows are not 16-byte aligned
    as a contiguous copy (the chunk scan still reads C's view); the head
    group may be forced (a sweep), within 1 to ``MAX_GROUP``."""
    stub = _StubSSD()
    monkeypatch.setattr(ops.build, "library", lambda name: stub)
    monkeypatch.setattr(ops, "_check_card", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132})())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77})())
    b, t, h, n = 2, 100, 3, 64
    buf = torch.zeros((b, t, n + 1))
    Cm = buf[..., 1:]                     # rows 4 bytes off 16, stride 65 floats
    Bm = torch.zeros((b, t, n))
    x = torch.zeros((b, t, h * 64 + 1))[..., 1:].reshape(b, t, h, 64)   # 4 bytes off 16
    la, dy = torch.zeros((b, t, h)), torch.zeros((b, t, h, 64))
    nc = -(-t // 64)
    scratch = (torch.zeros((b, nc, h, n, 64)), torch.zeros((b, nc, h, 64)))
    with pytest.raises(ValueError, match="head group"):
        ops.bwd_launches(la, Bm, Cm, x, dy, None, 64, scratch, group=ops.MAX_GROUP + 1)
    (*_, part), calls = ops.bwd_launches(la, Bm, Cm, x, dy, None, 64, scratch, group=2)
    assert part.shape[3] == 2
    for call in calls.values():
        call()
    (_, pass_args), (_, scan_args), _ = stub.calls
    assert pass_args[0] != Cm.data_ptr() and pass_args[0] % 16 == 0
    assert pass_args[5:7] == (t * n, n)   # the copy's strides
    assert scan_args[1] == Cm.data_ptr() and scan_args[12:14] == (t * (n + 1), n + 1)
    assert scan_args[2] != x.data_ptr() and scan_args[2] % 16 == 0
    assert scan_args[14:17] == (t * h * 64, h * 64, 64)   # the copy's strides
    stub.calls.clear()
    _, calls = ops.bwd_launches(la, Bm, Bm, x, dy, None, 64, scratch)
    calls["ssd_bwd_state_pass_kernel"]()
    assert stub.calls[0][1][0] == Bm.data_ptr()   # aligned rows: no copy
