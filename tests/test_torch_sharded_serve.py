"""The port's prefill and decode sharded on a device mesh (DTensor), on 8 gloo CPU ranks.

The reduced qwen2-1.5b (dense), mixtral-8x7b (the MoE, its sliding window
biting), zamba2-1.2b (Mamba-2 layers and the shared attention) and
whisper-large-v3 (the encoder and cross-attention) in float32 on a (4, 2)
("data", "model") mesh: `make_sharded_prefill_step` over a numpy-seeded
batch of 8 prompts of 16 tokens into a cache of 24 positions, then 8 steps
of `make_sharded_decode_step`, against the same steps of the unsharded port
(`make_prefill_step`, `make_decode_step`; ``tests/test_torch_lm_families.py``
holds those against the JAX package) on the same weights: the logits of the
prefill and of every decode step, and every leaf of the cache after the
prefill and after the last step, each rank's shard against the same slice of
the unsharded cache, within the sharded train step's bounds
(``tests/test_torch_sharded_train.py``: 1e-4).  Every cache leaf is placed as
`specs.cache_shardings` says (the KV caches' T over ``model``).  Each decode
step's collectives (`analysis.hlo.CollectiveRecorder`) hold no all-gather of
a KV cache's shard: no gathered tensor has a KV layer's (rows, positions,
kv heads, head dim) form.  The 8 ranks are spawned once for every case.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.hlo import CollectiveRecorder
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.launch.specs import (cache_shardings, make_decode_step, make_prefill_step,
                                      make_sharded_decode_step, make_sharded_prefill_step)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import tree_leaves

ARCHS = ("qwen2-1.5b", "mixtral-8x7b", "zamba2-1.2b", "whisper-large-v3")
SHAPE, AXES = (4, 2), ("data", "model")
WORLD = 8
B, S, STEPS = 8, 16, 8
MAX_LEN = S + STEPS
ATOL = 1e-4
SEED = 3
TIMEOUT_S = 600


def config(arch):
    return dataclasses.replace(registry.reduced_config(arch), dtype="float32")


def inputs(arch):
    """The prompt batch and the decode tokens, from a numpy seed."""
    cfg = config(arch)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S), np.int32))}
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (STEPS, B, 1), np.int32))
    return batch, tokens


def unsharded(arch):
    """-> (logits of the prefill and each step, cache after the prefill and
    after the last step, as {path: numpy})."""
    cfg = config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(SEED)
    batch, tokens = inputs(arch)
    logits, cache = make_prefill_step(model, MAX_LEN)(params, batch)
    first = {p: x.numpy().copy() for p, x in tree_leaves(cache)}
    out = [logits.numpy().copy()]
    decode = make_decode_step(model)
    for i in range(STEPS):
        logits, cache = decode(params, cache, tokens[i], S + i)
        out.append(logits.numpy().copy())
    return out, first, {p: x.numpy().copy() for p, x in tree_leaves(cache)}


class _Shapes(CollectiveRecorder):
    """A CollectiveRecorder that also keeps each all-gather's input shape."""

    def __init__(self):
        super().__init__()
        self.gathered = []

    def record(self, func, args, out):
        rec = super().record(func, args, out)
        if rec is not None and rec.kind == "all-gather":
            self.gathered.append(tuple(args[0].shape))
        return rec


def ranks_main(rank, world, want):
    import warnings

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    mesh = make_mesh(SHAPE, AXES, device_type="cpu", backend="gloo")
    out = {}
    for arch in ARCHS:
        cfg = config(arch)
        prefill = make_sharded_prefill_step(cfg, mesh, B, MAX_LEN, device="cpu")
        decode = make_sharded_decode_step(cfg, mesh, B, device="cpu")
        batch, tokens = inputs(arch)
        params, pbatch = prefill.place(build_model(cfg, device="cpu").init(SEED), batch)
        logits, cache = prefill(params, pbatch)
        specs = cache_shardings(cache, mesh, B)
        rec = dict(logits=[_diff(logits, want[arch][0][0])],
                   placed=all(x.placements == tuple(sharding.placements(
                       _get(specs, p), mesh)) for p, x in tree_leaves(cache)),
                   cache_first=_cache_diff(cache, want[arch][1], specs, mesh),
                   gathered=[], specs={p: _get(specs, p) for p, _ in tree_leaves(cache)})
        for i in range(STEPS):
            token = sharding.distribute(tokens[i], decode.batch_spec + (None,), mesh)
            with _Shapes() as mode:
                logits, cache = decode(params, cache, token, S + i)
            rec["logits"].append(_diff(logits, want[arch][0][i + 1]))
            rec["gathered"] += mode.gathered
        rec["cache_last"] = _cache_diff(cache, want[arch][2], specs, mesh)
        out[arch] = rec
    return out


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _diff(got, want):
    return float((got.full_tensor() - torch.from_numpy(want)).abs().max())


def _cache_diff(cache, want, specs, mesh):
    return {p: float((x.to_local() - sharding.local_part(
        torch.from_numpy(want[p]), _get(specs, p), mesh)).abs().max())
        for p, x in tree_leaves(cache)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = {arch: unsharded(arch) for arch in ARCHS}
    outs = run_ranks(ranks_main, WORLD, str(tmp_path_factory.mktemp("serve")), "gloo",
                     args=(want,), timeout_s=TIMEOUT_S)
    return want, outs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_unsharded(arch, runs):
    """Prefill and 8 decode steps: the logits and every cache leaf's shard
    within ATOL of the unsharded port's, on every rank."""
    _, outs = runs
    for r, out in enumerate(outs):
        rec = out[arch]
        assert max(rec["logits"]) < ATOL, (arch, r, rec["logits"])
        for key in ("cache_first", "cache_last"):
            worst = max(rec[key], key=rec[key].get)
            assert rec[key][worst] < ATOL, (arch, r, key, worst, rec[key][worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placed_by_its_specs_and_never_gathered(arch, runs):
    """Every cache leaf as cache_shardings places it, the KV leaves' T split
    over model; no decode step all-gathers a KV cache's shard or layer."""
    want, outs = runs
    cfg = config(arch)
    for out in outs:
        rec = out[arch]
        assert rec["placed"]
        kv = [p for p in rec["specs"] if p.split("/")[-1] in ("k", "v")]
        assert kv or cfg.family == "ssm"
        for p in kv:
            assert rec["specs"][p][2] == "model" and rec["specs"][p][1] == "data", p
        for shape in rec["gathered"]:
            assert not (len(shape) >= 4 and shape[-3] > 1
                        and shape[-2:] == (cfg.n_kv_heads, cfg.head_dim)), (arch, shape)
