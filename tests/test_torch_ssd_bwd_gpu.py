"""The SSD backward's CUDA kernels on a card.

Each case runs the forward kernels (keeping their scratch, as `SSDScan`
does) and ``ops.ssd_log_bwd`` twice on numpy-seeded operands and
cotangents, and holds it against ``ref.ssd_chunked_bwd_ref`` on the same
operands: two runs bitwise; every gradient within 1e-4 of its largest
magnitude, and a bf16 gradient (dB, dC, dx: both sides round float32 sums
to bf16 once) also within one bf16 ulp of its value (rtol 2^-7); the three
backward launches a call counted exactly.  The cases cover ragged T,
chunk 64 and 256, N 64 and 128, H that the head group does not divide,
the model's strided slices, no final-state cotangent, bf16 operands, and
sub-chunks whose last rows end inside an m16n8k8 tile (T 17 and 100 at N
128, T 641 at N 64 in bf16).  Then ``ssd_log`` under grad on a card: one
forward launch, and one launch of each backward kernel per
``backward()``.  Without a card every case skips;
this file imports no JAX, so a card's ``pytest -m gpu`` collects it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ops, ref

P = ops.HEAD_DIM
F32_REL = 1e-4
BF16_RTOL = 2.0 ** -7


def _operands(b, t, h, n, seed, strided, dtype, dev):
    """log_a over [-50, 0] a step; B, C, x (views of one (B, T, H P + 2 N)
    tensor, as the model slices its conv output, when ``strided``); dy; the
    final state's cotangent."""
    rng = np.random.default_rng(seed)
    log_a = torch.from_numpy((-rng.uniform(0.0, 1.0, (b, t, h)) ** 4 * 50.0).astype(np.float32))
    xbc = torch.from_numpy(rng.standard_normal((b, t, h * P + 2 * n), np.float32)).to(dev, dtype)
    x = xbc[..., :h * P].reshape(b, t, h, P)
    Bm, Cm = xbc[..., h * P:h * P + n], xbc[..., h * P + n:]
    if not strided:
        Bm, Cm, x = Bm.contiguous(), Cm.contiguous(), x.contiguous()
    dy = torch.from_numpy(rng.standard_normal((b, t, h, P), np.float32))
    ds = torch.from_numpy(rng.standard_normal((b, h, n, P), np.float32))
    return log_a.to(dev), Bm, Cm, x, dy.to(dev), ds.to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,n,chunk,dtype,strided,final", [
    (2, 1, 4, 64, 64, "float32", False, True),
    (2, 50, 8, 64, 64, "float32", False, True),
    (2, 641, 8, 128, 256, "float32", False, False),
    (2, 641, 20, 64, 64, "bfloat16", True, True),
    (1, 1000, 24, 128, 256, "bfloat16", True, False),
    (2, 300, 3, 128, 64, "float32", True, True),
    # 4 x 33 sub-chunks: heads in groups of 16 (ops.heads_per_block on an
    # H100's 132 SMs), the last group 4 or 8
    (4, 2112, 20, 64, 64, "bfloat16", True, True),
    (4, 2112, 24, 128, 64, "float32", False, True),
    # the mma tiles' edges inside a sub-chunk: 17 and 36 rows in the last
    (2, 17, 8, 128, 64, "float32", False, True),
    (2, 100, 8, 128, 64, "float32", False, False),
    (2, 641, 8, 64, 64, "bfloat16", True, True),
])
def test_cuda_bwd_kernels_match_plain_and_repeat(cuda, b, t, h, n, chunk, dtype, strided,
                                                 final):
    la, Bm, Cm, x, dy, ds = _operands(b, t, h, n, t + h, strided, getattr(torch, dtype), cuda)
    ds = ds if final else None
    _, _, scratch = ops._forward(la, Bm, Cm, x, chunk, "float32")
    before = dict(ops.ssd_log_bwd.kernel_launches)
    got = ops.ssd_log_bwd(la, Bm, Cm, x, dy, ds, chunk, scratch)
    again = ops.ssd_log_bwd(la, Bm, Cm, x, dy, ds, chunk, scratch)
    want = ref.ssd_chunked_bwd_ref(la, Bm, Cm, x, dy, ds, chunk)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in ops.ssd_log_bwd.kernel_launches.items()}
    assert counts == dict.fromkeys(ops.BWD_KERNELS, 2) and sum(counts.values()) == 2 * 3
    for name, g, a, w in zip(("dlog_a", "dB", "dC", "dx"), got, again, want):
        assert torch.equal(g, a), name
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(w.float().abs().max())
        rtol = BF16_RTOL if g.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(g.float(), w.float(), atol=F32_REL * scale, rtol=rtol,
                                   msg=name)


@pytest.mark.gpu
def test_ssd_log_under_grad_on_a_card_launches_the_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    la = (-torch.rand((1, 200, 4), generator=gen, device=cuda)).requires_grad_()
    Bm, Cm = (torch.randn((1, 200, 64), generator=gen, device=cuda, requires_grad=True)
              for _ in range(2))
    x = torch.randn((1, 200, 4, P), generator=gen, device=cuda, requires_grad=True)
    fwd, bwd = ops.ssd_log.launches, dict(ops.ssd_log_bwd.kernel_launches)
    y, st = ops.ssd_log(la, Bm, Cm, x, 64)
    assert ops.ssd_log.launches == fwd + 1
    assert ops.ssd_log_bwd.kernel_launches == bwd
    (y.square().sum() + st.sum()).backward()
    torch.cuda.synchronize()
    assert ops.ssd_log.launches == fwd + 1
    counts = {k: v - bwd[k] for k, v in ops.ssd_log_bwd.kernel_launches.items()}
    assert counts == dict.fromkeys(ops.BWD_KERNELS, 1) and sum(counts.values()) == 3
    want = ref.ssd_chunked_bwd_ref(la.detach(), Bm.detach(), Cm.detach(), x.detach(),
                                   2 * y.detach(), torch.ones_like(st), 64)
    for g, w in zip((la.grad, Bm.grad, Cm.grad, x.grad), want):
        torch.testing.assert_close(g, w, atol=F32_REL * float(w.abs().max()), rtol=0)
