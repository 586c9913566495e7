"""Every family of the port's `LM`, held against the JAX package's.

Each configuration's reduced form (`registry.reduced_config`: 2 layers, or
4 for the hybrid, widths 64) runs in both packages on the same parameters,
JAX's ``LM.init(PRNGKey(0))`` carried over by
`repro_torch.convert.lm_params_from_reference`, and the same numpy-seeded
batch (tokens, and the stubbed encoder frames or image embeddings):
``forward``'s logits and aux loss, ``prefill``'s last logits and every cache
leaf, then 4 ``decode_step``s (logits and cache), with ``use_kernels`` True
and False (on the CPU both reach the plain versions, the first through the
kernels' wrappers).  float32 at the JAX package's decode-vs-teacher-forcing
tolerance; bfloat16, for one configuration of each family served on the
card, by tests/test_torch_lm.py's rule (no farther from the reference's
float32 run than 1.5 times the reference's own bf16 run, plus one bf16 ulp
of the leaf's scale).  The reference's results are built once a module.
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
from test_torch_lm import _close, _hold

ARCHS = ref_registry.ARCH_IDS
#: One configuration of each family that the card serves, also run in bf16.
BF16_ARCHS = ("mamba2-130m", "qwen2-1.5b", "gemma-2b", "granite-moe-3b-a800m",
              "whisper-large-v3", "llama-3.2-vision-11b")
B, S, STEPS, MAX_LEN = 2, 11, 4, 16


def batch_np(cfg, b, s, seed=3):
    """Tokens, plus the stubbed frontend's output where the family takes one."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def reference_params(arch):
    cfg = ref_registry.reduced_config(arch)
    return jax.tree.map(np.asarray, ref_build_model(cfg).init(jax.random.PRNGKey(0)))


class Reference:
    """The JAX package's runs, each built on first use."""

    def __init__(self):
        self.params, self.runs = {}, {}

    def param(self, arch):
        if arch not in self.params:
            self.params[arch] = reference_params(arch)
        return self.params[arch]

    def run(self, arch, dtype):
        if (arch, dtype) not in self.runs:
            cfg = dataclasses.replace(ref_registry.reduced_config(arch), dtype=dtype)
            m = ref_build_model(cfg)
            params = self.param(arch)
            full = batch_np(cfg, B, S + STEPS)
            prompt = dict(full, tokens=full["tokens"][:, :S])
            fwd = jax.jit(m.forward)(params, to_jax(full))
            lg, cache = jax.jit(m.prefill, static_argnums=2)(params, to_jax(prompt), MAX_LEN)
            steps = [(lg, cache)]
            decode = jax.jit(m.decode_step)
            for t in range(S, S + STEPS):
                lg, cache = decode(params, cache, jnp.asarray(full["tokens"][:, t:t + 1]),
                                   jnp.int32(t))
                steps.append((lg, cache))
            self.runs[arch, dtype] = jax.tree.map(np.asarray, (fwd, steps))
        return self.runs[arch, dtype]


@pytest.fixture(scope="module")
def reference():
    return Reference()


def port_run(reference, arch, dtype, use_kernels):
    cfg = dataclasses.replace(registry.reduced_config(arch), dtype=dtype)
    m = build_model(cfg, device="cpu", use_kernels=use_kernels)
    params = convert.lm_params_from_reference(reference.param(arch))
    full = batch_np(cfg, B, S + STEPS)
    fwd = m.forward(params, to_torch(full))
    lg, cache = m.prefill(params, to_torch(dict(full, tokens=full["tokens"][:, :S])), MAX_LEN)
    steps = [(lg, {p: x.clone() for p, x in _flat(cache)})]
    for t in range(S, S + STEPS):
        lg, cache = m.decode_step(params, cache, torch.from_numpy(full["tokens"][:, t:t + 1]), t)
        steps.append((lg, {p: x.clone() for p, x in _flat(cache)}))
    return fwd, steps


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _hold_steps(port_steps, ref_steps_by_dtype, what):
    for i, (port, *refs) in enumerate(zip(port_steps, *ref_steps_by_dtype)):
        when = "prefill" if i == 0 else f"decode step {i}"
        _hold(port[0], [r[0] for r in refs], f"{what} {when} logits")
        _hold(port[1], [dict(_flat(r[1])) for r in refs], f"{what} {when} cache ")


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(reference, arch, use_kernels):
    (lg_r, aux_r), _ = reference.run(arch, "float32")
    (lg, aux), _ = port_run(reference, arch, "float32", use_kernels)
    _close(lg, lg_r, f"{arch} forward logits")
    _close(aux, aux_r, f"{arch} aux loss")
    if registry.get_config(arch).family != "moe":
        assert float(aux) == 0.0


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(reference, arch, use_kernels):
    _, ref_steps = reference.run(arch, "float32")
    _, steps = port_run(reference, arch, "float32", use_kernels)
    _hold_steps(steps, [ref_steps], arch)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_prefill_and_decode_match_reference(reference, arch, use_kernels):
    _, ref16 = reference.run(arch, "bfloat16")
    _, ref32 = reference.run(arch, "float32")
    _, steps = port_run(reference, arch, "bfloat16", use_kernels)
    _hold_steps(steps, [ref16, ref32], f"{arch} bf16")
