"""The flash-attention backward's CUDA kernels on a card.

Each case runs ``ops.flash_attention_bwd`` twice on numpy-seeded operands
(the forward kernel's O and LSE) and holds it against ``ref.flash_bwd_ref``
on the same operands: two runs bitwise, every gradient within ``tol`` times
the larger of its largest magnitude and `GRAD_FLOOR` (1e-4 float32, 2e-2
bf16), and the launches counted exactly (three a call, four on the split
grid).  The cases cover both dtypes at D 64, 128 and 256, masks, S 1, the
split grid (`ops.bwd_split`) and a GQA group summed inside one dkdv block
off it.  Without a card every case skips; this file imports no JAX, so a
card's ``pytest -m gpu`` collects it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import ops, ref

# At S 1 under the causal mask dQ and dK are P (dP - D) with P = 1 and
# dP = D up to rounding: a sum that cancels to 0 in one order and to ~1e-7
# in another.  A gradient of unit-scale operands is held at tol times the
# larger of its own scale and this floor (chip_smoke.py's BWD_ROW_FLOOR).
GRAD_FLOOR = 2.0 ** -10


def _operands(b, hq, hkv, s, d, seed=7):
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))
    return [rng.standard_normal(sh, np.float32) for sh in shapes]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,dtype,split", [
    (2, 4, 2, 200, 64, True, None, "float32", True),
    (2, 4, 1, 129, 128, False, None, "bfloat16", True),
    (2, 4, 2, 300, 128, True, 64, "bfloat16", True),
    (2, 2, 1, 65, 256, True, None, "float32", True),
    (2, 2, 2, 1, 64, True, None, "bfloat16", False),
    (2, 8, 1, 1000, 128, True, None, "bfloat16", True),   # 16 blocks -> 128
    (2, 4, 2, 129, 256, True, None, "bfloat16", True),    # D 256 on the tensor cores
    # the group summed inside a dkdv block: 66 x 2 x 2 and 33 x 2 x 4 = 264
    # kv-head blocks, at least 1.5 x 132
    (66, 4, 2, 256, 64, True, None, "bfloat16", False),
    (33, 4, 2, 256, 128, True, None, "float32", False),
])
def test_cuda_bwd_kernels_match_plain_and_repeat(cuda, b, hq, hkv, s, d, causal, window, dtype,
                                                 split):
    dt = getattr(torch, dtype)
    assert ops.bwd_split(b, hq, hkv, s, ops.bwd_key_tile(d, dt)) is split
    q, k, v, do = (torch.from_numpy(x).to(cuda, dt) for x in _operands(b, hq, hkv, s, d))
    o, lse = ops._forward(q, k, v, causal, window, d ** -0.5, with_lse=True)
    before = dict(ops.flash_attention_bwd.kernel_launches)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    for kernel, n in ops.flash_attention_bwd.kernel_launches.items():
        runs = split or kernel != "flash_bwd_dkdv_reduce_kernel"
        assert n == before[kernel] + 2 * runs, kernel
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        scale = max(float(w.float().abs().max()), GRAD_FLOOR)
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale, rtol=tol)
