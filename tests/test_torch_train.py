"""The port's training path, held against the JAX package's.

`LM.loss` and every gradient leaf of every reduced configuration (all six
families) against ``jax.value_and_grad`` of the JAX package's ``LM.loss``
on the same weights (JAX's ``LM.init(PRNGKey(0))`` carried over by
`repro_torch.convert.lm_params_from_reference`) and the same numpy-seeded
batch (some labels -1, masked): the loss at atol 5e-5 / rtol 1e-4, each
gradient within 1e-4 of its leaf's scale; with ``use_kernels`` True and
False, and with remat on (`torch.utils.checkpoint` around each of the JAX
package's remat units) bitwise the same as off.  The train step, the
crash/resume drill and `ssd_log` under grad are in
``tests/test_torch_train_drill.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import tree_leaves

ARCHS = ref_registry.ARCH_IDS
ATOL, RTOL = 5e-5, 1e-4
GRAD_REL = 1e-4
B, S = 2, 11


def batch_np(cfg, b=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1   # masked positions
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


class Reference:
    """The JAX package's weights and (loss, grads), each built on first use."""

    def __init__(self):
        self.params, self.grads = {}, {}

    def param(self, arch):
        if arch not in self.params:
            m = ref_build_model(ref_registry.reduced_config(arch))
            self.params[arch] = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0)))
        return self.params[arch]

    def loss_and_grads(self, arch):
        if arch not in self.grads:
            cfg = ref_registry.reduced_config(arch)
            batch = {k: jnp.asarray(v) for k, v in batch_np(cfg).items()}
            loss, g = jax.jit(jax.value_and_grad(ref_build_model(cfg).loss))(self.param(arch),
                                                                            batch)
            self.grads[arch] = (float(loss), dict(tree_leaves(jax.tree.map(np.asarray, g))))
        return self.grads[arch]


@pytest.fixture(scope="module")
def reference():
    return Reference()


def port_loss_and_grads(reference, arch, use_kernels, remat):
    cfg = dataclasses.replace(registry.reduced_config(arch), remat=remat)
    model = build_model(cfg, device="cpu", use_kernels=use_kernels)
    params = convert.lm_params_from_reference(reference.param(arch))
    paths, leaves = zip(*tree_leaves(params))
    for x in leaves:
        x.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(paths, grads))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch, use_kernels):
    want_loss, want = reference.loss_and_grads(arch)
    runs = {remat: port_loss_and_grads(reference, arch, use_kernels, remat)
            for remat in (False, True)}
    for remat, (loss, grads) in runs.items():
        np.testing.assert_allclose(loss, want_loss, atol=ATOL, rtol=RTOL)
        assert sorted(grads) == sorted(want), arch
        for path, g in grads.items():
            scale = float(np.abs(want[path]).max())
            err = float(np.abs(g.numpy() - want[path]).max())
            assert g.dtype == torch.float32 and g.shape == want[path].shape, path
            assert err <= GRAD_REL * scale, (arch, remat, path, err, scale)
    (loss0, g0), (loss1, g1) = runs[False], runs[True]
    assert loss0 == loss1
    assert all(torch.equal(g0[p], g1[p]) for p in g0), "remat changed a gradient"
