"""The port's optimizer, schedule and gradient compression.

Ports the five tests of ``tests/test_optim.py`` onto `repro_torch.optim`,
and holds the port against the JAX package's ``repro.optim`` on the same
numpy-seeded parameters and gradients: three `adamw_update` steps (with
clipping, weight decay and a warmup-cosine schedule) within 1e-6
relative, `warmup_cosine` at steps 0 to 60 at float32 tolerance, and
`compress_tree` bitwise (both round half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro.optim import schedule as ref_schedule
from repro_torch import convert
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                                     tree_leaves)
from repro_torch.optim.compression import compress_tree, compressed_gradients, init_error
from repro_torch.optim.schedule import warmup_cosine


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    target = torch.tensor([1.0, 2.0])
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=10.0)
    state = adamw_init(params)
    for _ in range(300):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), w)
        params, state, _ = adamw_update({"w": g}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clip_caps_update_norm():
    params = {"w": torch.zeros(3)}
    cfg = AdamWConfig(lr=1.0, grad_clip=0.5, weight_decay=0.0)
    _, _, metrics = adamw_update({"w": torch.tensor([100.0, 0.0, 0.0])}, adamw_init(params),
                                 params, cfg)
    assert float(metrics["grad_norm"]) == 100.0


def test_schedule_warmup_then_decay():
    sched = warmup_cosine(10, 100)
    assert float(sched(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(sched(torch.tensor(10, dtype=torch.int32))) == 1.0
    assert 0.09 < float(sched(torch.tensor(100, dtype=torch.int32))) < 0.11
    assert float(sched(torch.tensor(55, dtype=torch.int32))) < 1.0


def test_error_feedback_compression_is_unbiased_over_time():
    """EF-int8 SGD tracks exact SGD on a quadratic (error feedback works)."""
    w_exact = np.array([4.0, -2.0, 1.0], np.float64)
    w_comp = w_exact.copy()
    err = init_error({"w": torch.from_numpy(w_comp)})
    lr = 0.05
    for _ in range(200):
        w_exact -= lr * 2 * (w_exact - 1.0)
        deq, err = compressed_gradients({"w": torch.from_numpy(2 * (w_comp - 1.0))}, err)
        w_comp -= lr * deq["w"].double().numpy()
    np.testing.assert_allclose(w_comp, w_exact, atol=5e-2)


def test_compression_payload_is_int8():
    g = {"a": torch.ones(64) * 3.3, "b": torch.linspace(-1, 1, 32)}
    q, s, _ = compress_tree(g, {k: torch.zeros_like(v) for k, v in g.items()})
    assert all(leaf.dtype == torch.int8 for _, leaf in tree_leaves(q))
    np.testing.assert_allclose((q["a"].float() * s["a"]).numpy(), 3.3 * np.ones(64), rtol=0.02)


# ----- parity with the JAX package --------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((2, 5, 7), np.float32),
                       "ln": {"scale": 1.0 + rng.standard_normal((2, 7), np.float32) * 0.1}},
            "embed": rng.standard_normal((11, 7), np.float32) * 3.0}


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


@pytest.mark.parametrize("grad_clip", [1.0, 100.0])
def test_adamw_matches_reference_over_three_steps(grad_clip):
    params_np = _tree(0)
    grads_np = [_tree(s) for s in (1, 2, 3)]
    ref_cfg = ref_adamw.AdamWConfig(lr=1e-2, grad_clip=grad_clip,
                                    schedule=ref_schedule.warmup_cosine(2, 10))
    cfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip, schedule=warmup_cosine(2, 10))
    rp = jax.tree.map(jnp.asarray, params_np)
    rs = ref_adamw.adamw_init(rp)
    p = convert.lm_params_from_reference(params_np)
    st = convert.adamw_state_from_reference(jax.tree.map(np.asarray, rs))
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    for g in grads_np:
        rp, rs, rm = ref_adamw.adamw_update(jax.tree.map(jnp.asarray, g), rs, rp, ref_cfg)
        p, st, m = adamw_update(convert.lm_params_from_reference(g), st, p, cfg)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(rm[name]), rtol=1e-6)
    assert int(st["step"]) == int(rs["step"]) == 3
    for tree, ref in ((p, rp), (st["m"], rs["m"]), (st["v"], rs["v"])):
        want = dict(tree_leaves(_np(jax.tree.map(np.asarray, ref))))
        for path, leaf in tree_leaves(tree):
            scale = np.abs(want[path]).max()
            np.testing.assert_allclose(leaf.numpy(), want[path], rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=path)


def test_global_norm_matches_reference():
    g = _tree(4)
    want = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, g)))
    np.testing.assert_allclose(float(global_norm(convert.lm_params_from_reference(g))), want,
                               rtol=1e-6)


def test_warmup_cosine_matches_reference():
    ref_fn = ref_schedule.warmup_cosine(10, 50)
    fn = warmup_cosine(10, 50)
    steps = np.arange(61, dtype=np.int32)
    want = np.asarray([float(ref_fn(jnp.int32(s))) for s in steps], np.float32)
    got = fn(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)


def test_compress_tree_bitwise_reference():
    g = _tree(5)
    g["ties"] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)   # half to even
    err = jax.tree.map(lambda x: np.random.default_rng(6).standard_normal(
        np.shape(x)).astype(np.float32) * 0.01, g)
    err["ties"] = np.zeros(6, np.float32)   # 127.0 sets the scale to 1: exact halves
    rq, rsc, re = ref_compression.compress_tree(jax.tree.map(jnp.asarray, g),
                                                jax.tree.map(jnp.asarray, err))
    q, sc, e = compress_tree(convert.lm_params_from_reference(g),
                             convert.lm_params_from_reference(err))
    for port, ref in ((q, rq), (sc, rsc), (e, re)):
        want = dict(tree_leaves(_np(jax.tree.map(np.asarray, ref))))
        for path, leaf in tree_leaves(port):
            assert leaf.numpy().dtype == want[path].dtype, path
            assert np.array_equal(leaf.numpy(), want[path]), path
