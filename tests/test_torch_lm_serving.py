"""The port's serving tests for every LM family, and what the families add.

Ports of tests/test_models.py's serving tests onto the port's `LM`
(decode against teacher forcing for every configuration, the MoE capacity
test, the sliding window, the full configurations' parameter shapes), then
what the new families bring: the MoE router's tie rule (``jax.lax.top_k``:
of equal gates the lower expert index first) on planted ties, the one-hot
and scatter dispatches against each other and against the JAX package's,
gemma's float32 residual stream under ``dtype="bfloat16"`` (the JAX
package's ``embed_scale`` promotion, kept), and the parameter trees
`convert.lm_params_from_reference` carries over.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as ref_moe
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import moe
from repro_torch.models.model import LM, build_model
from test_torch_lm import ATOL, RTOL, _close, _leaves
from test_torch_lm_families import batch_np, reference_params, to_jax, to_torch

ARCHS = ref_registry.ARCH_IDS
MOE_ARCHS = [a for a in ARCHS if ref_registry.get_config(a).family == "moe"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """tests/test_models.py::test_decode_matches_teacher_forcing on the port."""
    cfg = registry.reduced_config(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)  # no drops
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    b, s = 2, 12
    batch = to_torch(batch_np(cfg, b, s + 1))
    toks = batch["tokens"]
    full, _ = m.forward(params, batch)
    _, cache = m.prefill(params, dict(batch, tokens=toks[:, :s]), s + 4)
    lg, _ = m.decode_step(params, cache, toks[:, s:s + 1], s)
    np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(), atol=ATOL, rtol=RTOL)


def test_moe_capacity_drops_are_only_train_prefill_difference():
    """tests/test_models.py:82: with no drops the logits are finite, and the
    drops at the configured capacity are all that moves the forward."""
    base = registry.reduced_config("mixtral-8x7b")
    cfg = dataclasses.replace(base, capacity_factor=100.0)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    batch = to_torch(batch_np(cfg, 2, 8))
    logits, _ = m.forward(params, batch)
    assert bool(torch.isfinite(logits).all())
    dropped, _ = build_model(base, device="cpu").forward(params, batch)
    assert float((dropped - logits).abs().max()) > 1e-4
    _, cache = m.prefill(params, dict(batch, tokens=batch["tokens"][:, :7]), 8)
    lg, _ = m.decode_step(params, cache, batch["tokens"][:, 7:8], 7)
    np.testing.assert_allclose(lg.numpy(), logits[:, 7].numpy(), atol=ATOL, rtol=RTOL)


def test_sliding_window_changes_output():
    """tests/test_models.py:91 on the reduced mixtral (window 8)."""
    cfg = registry.reduced_config("mixtral-8x7b")
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    batch = to_torch(batch_np(cfg, 2, 16))
    l1, _ = m.forward(params, batch)
    l2, _ = build_model(dataclasses.replace(cfg, sliding_window=2), device="cpu").forward(
        params, batch)
    assert float((l1 - l2).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_shapes_match_reference(arch):
    """Every leaf's path, shape and dtype as the JAX package's tree; the total
    within tests/test_models.py:73's 6 % of the analytic count."""
    cfg = registry.get_config(arch)
    shapes = jax.eval_shape(ref_build_model(ref_registry.get_config(arch)).init,
                            jax.random.PRNGKey(0))
    ref_leaves = {p: (tuple(x.shape), str(x.dtype)) for p, x in _leaves(shapes)}
    port_leaves = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                   for p, x in _leaves(LM(cfg, device="meta").init(0))}
    assert port_leaves == ref_leaves
    total = sum(int(np.prod(s)) for s, _ in port_leaves.values())
    assert abs(total - cfg.param_count()) / cfg.param_count() < 0.06


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_builds_and_converts(arch):
    """`LM(cfg, device="cpu")` takes every configuration; the JAX package's
    reduced tree carried over has the paths, shapes and dtypes of the
    port's own `LM.init`."""
    LM(registry.get_config(arch), device="cpu")
    carried = convert.lm_params_from_reference(reference_params(arch))
    own = LM(registry.reduced_config(arch), device="cpu").init(0)
    assert ({p: (tuple(x.shape), x.dtype) for p, x in _leaves(carried)}
            == {p: (tuple(x.shape), x.dtype) for p, x in _leaves(own)})


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("pattern", ["all_equal", "pairs", "kth_place"])
def test_router_ties_pick_the_reference_experts(pattern, k):
    """Planted ties, values and indices as ``jax.lax.top_k`` gives them."""
    rng = np.random.default_rng(11)
    e = 40
    gates = rng.random((3, 64, e)).astype(np.float32)
    if pattern == "all_equal":
        gates[:] = 0.025
    elif pattern == "pairs":
        gates[..., 1::2] = gates[..., 0::2]
    else:    # the k-th and (k+1)-th largest equal, at shuffled places
        order = np.argsort(-gates, axis=-1)
        kth = np.take_along_axis(gates, order[..., k - 1:k], -1)
        np.put_along_axis(gates, order[..., k:k + 1], kth, -1)
    vals, idx = moe.top_k(torch.from_numpy(gates), k)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(gates), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_in_bf16_logits(dtype):
    """Duplicated router columns give exactly equal logits: `route` picks
    the experts the JAX package's routing picks (and its weights)."""
    cfg = dataclasses.replace(registry.reduced_config("granite-moe-3b-a800m"), dtype=dtype)
    rng = np.random.default_rng(12)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(np.float32)
    router[:, 1::2] = router[:, 0::2]
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    gates, topv, topi = moe.route({"router": torch.from_numpy(router)}, xt, cfg)
    logits = (jnp.asarray(x, dtype) @ jnp.asarray(router).astype(dtype)).astype(jnp.float32)
    ref_v, ref_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    ref_v = ref_v / jnp.maximum(ref_v.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(topv.numpy(), np.asarray(ref_v), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_onehot_and_scatter_agree(arch, dtype):
    """The two dispatches give the same bits (the JAX package's claim,
    moe.py:166), with tokens dropped; each matches the JAX package's."""
    cfg = dataclasses.replace(registry.reduced_config(arch), dtype=dtype)
    params = convert.lm_params_from_reference(reference_params(arch))["blocks"]["moe"]
    p0 = {k: v[0] for k, v in params.items()}
    x = np.random.default_rng(13).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    _, _, topi = moe.route(p0, xt, cfg)
    load = torch.nn.functional.one_hot(topi.reshape(2, -1), cfg.n_experts).sum(1)
    assert bool((load > moe._capacity(12, cfg)).any()), "no token dropped"
    one, aux1 = moe.moe_apply_onehot(p0, xt, cfg)
    sc, aux2 = moe.moe_apply_scatter(p0, xt, cfg)
    assert torch.equal(one, sc) and torch.equal(aux1, aux2)
    p0_np = {k: v.numpy() for k, v in p0.items()}
    for fn in (ref_moe.moe_apply_onehot, ref_moe.moe_apply_scatter):
        ref, ref_aux = fn(p0_np, jnp.asarray(x, dtype), cfg)
        if dtype == "float32":
            _close(one, ref, f"{fn.__name__} out")
        else:   # one rounding of the expert GEMMs' outputs apart
            np.testing.assert_allclose(one.float().numpy(), np.asarray(ref, np.float32),
                                       atol=2.0 ** -7 * float(np.abs(ref).max()))
        _close(aux1, ref_aux, f"{fn.__name__} aux")


def test_gemma_bf16_residual_stream_is_float32():
    """The reduced gemma under dtype="bfloat16": the embeddings times a float32
    sqrt(d_model) promote the residual stream to float32 in both packages
    (the JAX package's semantic, kept), so the forward logits agree at the
    float32 tolerance; the KV cache stays bf16."""
    cfg = dataclasses.replace(registry.reduced_config("gemma-2b"), dtype="bfloat16")
    ref_m = ref_build_model(dataclasses.replace(ref_registry.reduced_config("gemma-2b"),
                                                dtype="bfloat16"))
    ref_params = reference_params("gemma-2b")
    batch = batch_np(cfg, 2, 12)
    m = build_model(cfg, device="cpu")
    params = convert.lm_params_from_reference(ref_params)
    toks = torch.from_numpy(batch["tokens"])
    x = m._embed(params, toks, torch.arange(12))
    assert x.dtype == torch.float32
    assert ref_m._embed(ref_params, jnp.asarray(batch["tokens"])).dtype == jnp.float32
    lg, _ = m.forward(params, to_torch(batch))
    lg_r, _ = ref_m.forward(ref_params, to_jax(batch))
    _close(lg, lg_r, "gemma bf16 forward logits")
    _, cache = m.prefill(params, to_torch(batch), 16)
    assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16
