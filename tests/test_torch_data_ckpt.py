"""The port's data pipeline and checkpoints.

Ports the six tests of ``tests/test_data_and_ckpt.py`` onto
`repro_torch.data` and `repro_torch.checkpoint`; pins `pack_documents`,
`synthetic_corpus`, `TokenPipeline.batch_at` and `host_slice` bitwise
against the JAX package's numpy originals; and round-trips a checkpoint of
an `LM`'s parameters with its AdamW state (float32, a bfloat16 leaf stored
as its words, the int32 step), restored onto the template's dtype.
"""
import os

import numpy as np
import pytest
import torch

from repro.data import packing as ref_packing
from repro.data import pipeline as ref_pipeline
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.packing import pack_documents, synthetic_corpus
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init, tree_leaves


def test_packing_preserves_tokens_and_index():
    docs, srcs = synthetic_corpus(n_docs=40, vocab=128, mean_len=50, seed=1)
    shards = pack_documents(docs, srcs, shard_len=128)
    for i, doc in enumerate(docs):
        p, o = shards.index[i]
        flat_from = shards.tokens[p].reshape(-1)[o:o + min(len(doc), 128 - o)]
        np.testing.assert_array_equal(flat_from, doc[:len(flat_from)])
    assert (shards.doc_ids >= 0).sum() == sum(len(d) for d in docs)


def test_structured_shards_prune_by_source():
    docs, srcs = synthetic_corpus(n_docs=60, vocab=128, n_sources=3, seed=2)
    shards = pack_documents(docs, srcs, shard_len=128, structured=True)
    pruned = shards.prune([0])
    assert pruned.n_shards < shards.n_shards
    assert set(np.unique(pruned.source_key)) == {0}


def test_pipeline_is_deterministic_function_of_step():
    docs, srcs = synthetic_corpus(n_docs=50, vocab=64, seed=3)
    shards = pack_documents(docs, srcs, shard_len=256)
    p1 = TokenPipeline(shards, PipelineConfig(4, 32, seed=9))
    p2 = TokenPipeline(shards, PipelineConfig(4, 32, seed=9))
    for step in (0, 7, 1000):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    assert not np.array_equal(p1.batch_at(0)["tokens"], p1.batch_at(1)["tokens"])
    b = p1.batch_at(5)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_slice_partitions_batch():
    docs, srcs = synthetic_corpus(n_docs=50, vocab=64, seed=3)
    p = TokenPipeline(pack_documents(docs, srcs, shard_len=256), PipelineConfig(8, 16, seed=0))
    b = p.batch_at(0)
    parts = [p.host_slice(b, h, 4)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), b["tokens"])


def test_checkpoint_roundtrip_and_gc(tmp_path):
    state = {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4)},
        "opt": {"m": {"w": torch.zeros(3, 4)}, "step": torch.tensor(7, dtype=torch.int32)},
    }
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, state)
    assert mgr.steps() == [20, 30]  # GC'd step 10
    step, restored = mgr.restore(30, state)
    assert step == 30
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["opt"]["step"]) == 7 and restored["opt"]["step"].dtype == torch.int32


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(5, {"params": {"x": torch.ones(2)}})
    mgr.wait()
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert mgr.latest_step() == 5


# ----- bitwise against the JAX package's numpy originals -----------------------

@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("seed,n_docs,vocab,mean_len,n_sources,shard_len", [
    (0, 40, 128, 50, 4, 128), (5, 100, 1024, 384, 3, 512), (7, 7, 512, 20, 1, 64)])
def test_packing_bitwise_reference(structured, seed, n_docs, vocab, mean_len, n_sources,
                                   shard_len):
    got_docs, got_srcs = synthetic_corpus(n_docs, vocab, mean_len, n_sources, seed)
    want_docs, want_srcs = ref_packing.synthetic_corpus(n_docs, vocab, mean_len, n_sources, seed)
    assert got_srcs == want_srcs
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got_docs, want_docs))
    got = pack_documents(got_docs, got_srcs, shard_len, structured)
    want = ref_packing.pack_documents(want_docs, want_srcs, shard_len, structured)
    for name in ("tokens", "doc_ids", "source_key"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.index == want.index
    pruned, pruned_ref = got.prune([0]), want.prune([0])
    assert np.array_equal(pruned.tokens, pruned_ref.tokens) and pruned.index == pruned_ref.index


@pytest.mark.parametrize("batch,seq,seed", [(4, 32, 9), (8, 16, 0), (2, 255, 3)])
def test_pipeline_bitwise_reference(batch, seq, seed):
    docs, srcs = synthetic_corpus(n_docs=80, vocab=300, seed=seed)
    shards = pack_documents(docs, srcs, shard_len=512)
    ref_shards = ref_packing.pack_documents(*ref_packing.synthetic_corpus(
        n_docs=80, vocab=300, seed=seed), shard_len=512)
    pipe = TokenPipeline(shards, PipelineConfig(batch, seq, seed=seed))
    ref_pipe = ref_pipeline.TokenPipeline(ref_shards, ref_pipeline.PipelineConfig(batch, seq,
                                                                                  seed=seed))
    for step in (0, 1, 6, 12345):
        got, want = pipe.batch_at(step), ref_pipe.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (step, k)
        for h in range(2):
            a, b = pipe.host_slice(got, h, 2), ref_pipe.host_slice(want, h, 2)
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_checkpoint_roundtrip_lm_params_and_adamw_state(tmp_path):
    cfg = registry.reduced_config("granite-moe-3b-a800m")
    params = build_model(cfg, device="cpu").init(3)
    opt = adamw_init(params)
    gen = torch.Generator().manual_seed(4)
    for _, leaf in tree_leaves(opt["m"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    opt["step"] += 5
    params["embed"]["embedding"] = params["embed"]["embedding"].bfloat16()   # a bf16 leaf
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last=1)
    mgr.save(5, {"params": params, "opt": opt})
    mgr.wait()
    with np.load(str(tmp_path / "ckpt" / "step_5" / "params.npz")) as z:
        assert z["embed/embedding"].dtype == np.uint16
    template = {"params": build_model(cfg, device="cpu").init(9)}
    template["opt"] = adamw_init(template["params"])
    template["params"]["embed"]["embedding"] = template["params"]["embed"]["embedding"].bfloat16()
    step, restored = mgr.restore(mgr.latest_step(), template)
    assert step == 5
    for group, tree in (("params", params), ("opt", opt)):
        want = dict(tree_leaves(tree))
        got = dict(tree_leaves(restored[group]))
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            assert leaf.dtype == want[path].dtype and torch.equal(leaf, want[path]), (group, path)
