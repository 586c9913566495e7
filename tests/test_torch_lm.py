"""The port's hybrid (Zamba-2) language model, held against the JAX package.

The reduced ``zamba2-1.2b`` configuration (4 Mamba-2 layers in 2 groups, a
shared attention block after each, widths 64) runs in both packages on the
same parameters: JAX's ``LM.init(PRNGKey(0))`` carried over by
`repro_torch.convert.lm_params_from_reference`.  Prefill logits, every cache
leaf and three decode steps are held at the JAX package's own
decode-vs-teacher-forcing tolerance (atol 5e-5 / rtol 1e-4,
tests/test_models.py:56) in float32, through the port's kernel wrappers
(their plain versions on the CPU) and through its plain formulations.  In
bfloat16 the two frameworks round at other places (XLA on the CPU keeps
fused intermediates in float32), and at these widths either package's
bf16 logits lie some 2 % of their scale from its float32 ones.  So a bf16
leaf is held to the reference's own bf16 error: its distance from the
reference's float32 run may be at most 1.5 times the reference's bf16
run's distance, plus one bf16 ulp (2**-8) of the leaf's scale.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models.model import LM, build_model

ATOL, RTOL = 5e-5, 1e-4
BF16_FACTOR, BF16_ULP = 1.5, 2.0 ** -8
ARCH = "zamba2-1.2b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(port, ref, what):
    """float32: the reference's tolerance."""
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL, err_msg=what)


def _close_bf16(port, ref16, ref32, what):
    """bfloat16: no farther from the reference's float32 run than its own bf16 run."""
    port = port.float().numpy()
    ref16, ref32 = np.asarray(ref16, np.float32), np.asarray(ref32, np.float32)
    assert port.shape == ref32.shape, (what, port.shape, ref32.shape)
    own = float(np.abs(ref16 - ref32).max())
    err = float(np.abs(port - ref32).max())
    ulp = BF16_ULP * float(np.abs(ref32).max())
    assert err <= BF16_FACTOR * own + ulp, (
        f"{what}: port {err:.3g} from the float32 run, reference's bf16 run {own:.3g}")


def _hold(port_tree, refs, what):
    """Hold every leaf (or the logits) against the reference run(s)."""
    port = dict(_leaves(port_tree))
    ref = [dict(_leaves(r)) for r in refs]
    assert sorted(port) == sorted(ref[0]), what
    for path, leaf in port.items():
        assert leaf.dtype == getattr(torch, str(ref[0][path].dtype)), (what, path)
        if len(refs) == 1:
            _close(leaf, ref[0][path], what + path)
        else:
            _close_bf16(leaf, ref[0][path], ref[1][path], what + path)


@pytest.fixture(scope="module")
def reference_params():
    cfg = ref_registry.reduced_config(ARCH)
    return _np_tree(ref_build_model(cfg).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_match_reference(reference_params, dtype, use_kernels):
    b, s, max_len, steps = 2, 11, 16, 3
    dtypes = [dtype] if dtype == "float32" else [dtype, "float32"]
    ref_models = [ref_build_model(dataclasses.replace(ref_registry.reduced_config(ARCH),
                                                      dtype=d)) for d in dtypes]
    cfg = dataclasses.replace(registry.reduced_config(ARCH), dtype=dtype)
    m = build_model(cfg, device="cpu", use_kernels=use_kernels)
    params = convert.lm_params_from_reference(reference_params)
    toks = _tokens(cfg, b, s + steps)

    refs = [rm.prefill(reference_params, {"tokens": jnp.asarray(toks[:, :s])}, max_len)
            for rm in ref_models]
    lg, cache = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])}, max_len)
    _hold(lg, [r[0] for r in refs], "prefill logits")
    _hold(cache, [r[1] for r in refs], "prefill cache ")
    for t in range(s, s + steps):
        tok = toks[:, t:t + 1]
        refs = [rm.decode_step(reference_params, r[1], jnp.asarray(tok), jnp.int32(t))
                for rm, r in zip(ref_models, refs)]
        lg, cache = m.decode_step(params, cache, torch.from_numpy(tok), t)
        _hold(lg, [r[0] for r in refs], f"decode logits at {t}")
        _hold(cache, [r[1] for r in refs], f"decode cache at {t} ")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_matches_reference(reference_params, use_kernels):
    cfg = registry.reduced_config(ARCH)
    toks = _tokens(cfg, 2, 12, seed=5)
    lg_r, _ = ref_build_model(ref_registry.reduced_config(ARCH)).forward(
        reference_params, {"tokens": jnp.asarray(toks)})
    lg, aux = build_model(cfg, device="cpu", use_kernels=use_kernels).forward(
        convert.lm_params_from_reference(reference_params), {"tokens": torch.from_numpy(toks)})
    _close(lg, lg_r, "forward logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_matches_teacher_forcing(use_kernels):
    """Port of tests/test_models.py::test_decode_matches_teacher_forcing (hybrid)."""
    cfg = registry.reduced_config(ARCH)
    m = build_model(cfg, device="cpu", use_kernels=use_kernels)
    params = m.init(0)
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(cfg, b, s + 1))
    full, _ = m.forward(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :s]}, s + 4)
    lg, _ = m.decode_step(params, cache, toks[:, s:s + 1], s)
    np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(), atol=ATOL, rtol=RTOL)


def test_ragged_prompt_against_chunk_and_decode():
    """A prompt shorter than the conv width and not a multiple of the chunk."""
    cfg = registry.reduced_config(ARCH)
    m = build_model(cfg, device="cpu")
    params = m.init(1)
    toks = torch.from_numpy(_tokens(cfg, 1, 6, seed=9))
    full, _ = m.forward(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :2]}, 8)
    for t in range(2, 6):
        lg, cache = m.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_configs_equal_reference(arch):
    port, ref = registry.get_config(arch), ref_registry.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert dataclasses.asdict(registry.reduced_config(arch)) == dataclasses.asdict(
        ref_registry.reduced_config(arch))


def test_full_config_parameter_shapes_match_reference():
    cfg = registry.get_config(ARCH)
    shapes = jax.eval_shape(ref_build_model(ref_registry.get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    ref_leaves = {p: (tuple(x.shape), str(x.dtype)) for p, x in _leaves(shapes)}
    params = LM(cfg, device="meta").init(0)
    port_leaves = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                   for p, x in _leaves(params)}
    assert port_leaves == ref_leaves
    total = sum(int(np.prod(s)) for s, _ in port_leaves.values())
    assert abs(total - cfg.param_count()) / cfg.param_count() < 1e-3


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(registry.reduced_config(ARCH))


def test_init_is_seeded_and_follows_the_reference_scales():
    cfg = registry.reduced_config(ARCH)
    a, b = LM(cfg, device="cpu").init(4), LM(cfg, device="cpu").init(4)
    for (p, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), p
    assert float(a["embed"]["embedding"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(a["blocks"]["mamba"]["conv_w"].std()) == pytest.approx(0.1, rel=0.2)
    assert torch.equal(a["blocks"]["mamba"]["D"], torch.ones_like(a["blocks"]["mamba"]["D"]))


def test_lm_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.models.model, repro_torch.configs.registry, repro_torch.convert\n"
        "import repro_torch.models.moe, repro_torch.models.blocks, repro_torch.models.attention\n"
        "import repro_torch.models.layers, repro_torch.models.ssm\n"
        "import repro_torch.kernels.attention.ops, repro_torch.kernels.ssd.ops\n"
        "from repro_torch.configs.registry import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'jaxlib' not in sys.modules\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
