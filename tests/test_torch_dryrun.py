"""The port's dry run (`repro_torch.launch.dryrun`) and the rest of its
``launch/specs.py`` against the JAX package's.

Device-free, for every arch x shape on the 16 x 16 and 2 x 16 x 16 meshes
(the reference's on ``jax.sharding.AbstractMesh``, the port's on ``{axis:
size}`` mappings, as ``tests/test_torch_sharding.py`` holds the rules):
``shape_applicable``; ``batch_specs``' shapes and dtypes; every spec of
``batch_shardings``, ``cache_shardings`` and ``build_cell``'s
``in_shardings`` and ``out_shardings``; ``_probe_cfgs``; ``_scale_costs``
bitwise on the same inputs; and each cell's per-device argument bytes,
equal to the reference's ``NamedSharding.shard_shape`` summed over its
``CellSpec``'s arguments.

Traced (``FakeTensorMode`` on a fake process group), on two cells at full
size, qwen2-1.5b ``train_4k`` and zamba2-1.2b ``decode_32k`` on 16 x 16:
the full trace equals its scaled probes, for FLOPs and link bytes, and its
argument bytes the device-free count.  On the reduced qwen2-1.5b train step
(8 x 16 tokens) on a fake (4, 2) mesh: the trace's FLOPs equal an analytic
count of its matrix products and attention (each a rank's eighth), and its
collective records (kind, count, payload, link bytes) equal those of the
same step run for real on 8 gloo ranks.
"""
import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import dryrun as ref_dryrun
from repro.launch import specs as ref_specs
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh, run_ranks

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TRACED = (("qwen2-1.5b", "train_4k"), ("zamba2-1.2b", "decode_32k"))
B, S_LEN = 8, 16


def sizes(mesh):
    shape, axes = MESHES[mesh]
    return dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def ref_cell(arch, shape, mesh):
    cfg = ref_registry.get_config(arch)
    return ref_specs.build_cell(cfg, next(s for s in REF_SHAPES if s.name == shape),
                                AbstractMesh(*MESHES[mesh]))


def as_specs(tree):
    """A reference sharding tree as the port's: NamedSharding -> its spec
    as a tuple."""
    if isinstance(tree, NamedSharding):
        return tuple(tree.spec)
    if isinstance(tree, dict):
        return {k: as_specs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(as_specs(v) for v in tree)
    return tree


def ref_arg_bytes(cell):
    total = 0
    for arg, shard in zip(cell.args, cell.in_shardings):
        leaves = jax.tree_util.tree_leaves(arg)
        shards = jax.tree_util.tree_leaves(shard)
        assert len(leaves) == len(shards)
        for leaf, sh in zip(leaves, shards):
            total += int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return total


def cells():
    return [(a, s.name) for a in registry.ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", cells())
def test_cell_specs_match_reference(arch, shape, mesh):
    cfg, rcfg = registry.get_config(arch), ref_registry.get_config(arch)
    shp = SHAPE_BY_NAME[shape]
    rshp = next(s for s in REF_SHAPES if s.name == shape)
    ok = S.shape_applicable(cfg, shp)
    assert ok == ref_specs.shape_applicable(rcfg, rshp)
    got_batch = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                 for k, v in S.batch_specs(cfg, shp).items()}
    want_batch = {k: (tuple(v.shape), str(v.dtype))
                  for k, v in ref_specs.batch_specs(rcfg, rshp).items()}
    assert got_batch == want_batch
    am, pm = AbstractMesh(*MESHES[mesh]), sizes(mesh)
    assert S.batch_shardings(cfg, shp, pm) == as_specs(ref_specs.batch_shardings(rcfg, rshp, am))
    if not ok[0]:
        return
    want, got = ref_cell(arch, shape, mesh), S.build_cell(cfg, shp, pm)
    assert got.in_shardings == as_specs(want.in_shardings)
    assert got.out_shardings == as_specs(want.out_shardings)
    assert got.donate_argnums == want.donate_argnums
    assert dryrun.argument_bytes(got, pm) == ref_arg_bytes(want)
    if shp.kind == "decode":
        model = __import__("repro.models.model", fromlist=["build_model"]).build_model(rcfg)
        rcache = jax.eval_shape(lambda: model.init_cache(shp.global_batch, shp.seq_len))
        pcache = got.args[1]
        assert (S.cache_shardings(pcache, pm, shp.global_batch)
                == as_specs(ref_specs.cache_shardings(rcache, am, shp.global_batch)))
        assert got.args[2].shape == want.args[2].shape and got.args[3].shape == ()


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_probe_cfgs_and_scale_costs_match_reference(arch):
    got, got_info = dryrun._probe_cfgs(registry.get_config(arch))
    want, want_info = ref_dryrun._probe_cfgs(ref_registry.get_config(arch))
    assert got_info == want_info
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    rng = np.random.default_rng(len(arch))
    kinds = ("all-gather", "all-reduce", "reduce-scatter")
    probes = {name: {"cost": {"flops": float(rng.uniform(1e9, 1e15)),
                              "bytes_accessed": float(rng.uniform(1e9, 1e13))},
                     "collectives": {k: {"count": 3, "payload_bytes": 1.0,
                                         "link_bytes": float(rng.uniform(0, 1e11))}
                                     for k in kinds}}
              for name in got}
    fam = registry.get_config(arch).family
    assert dryrun._scale_costs(fam, probes, got_info) == \
        ref_dryrun._scale_costs(fam, probes, want_info)


@pytest.fixture(scope="module")
def fake_group():
    """Meshes over fake process groups; the default group is left again,
    so that later test files in this worker find none."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", TRACED)
def test_full_trace_equals_scaled_probes(arch, shape, fake_group):
    res = dryrun.run_cell(arch, shape, "single")
    prod = res["production"]
    sc = res["scaled_cost"]
    assert res["mesh_shape"] == {"data": 16, "model": 16}
    assert prod["cost"]["flops"] > 0 and prod["memory"]["temp_bytes"] > 0
    assert sc["flops"] == prod["cost"]["flops"], (sc["flops"], prod["cost"]["flops"])
    coll = sum(v["link_bytes"] for v in prod["collectives"].values())
    assert abs(sc["coll"] - coll) <= 1e-9 * coll, (sc["coll"], coll)
    assert abs(sc["coll_nvlink"] + sc["coll_network"] - sc["coll"]) <= 1e-9 * coll
    cell = S.build_cell(registry.get_config(arch), SHAPE_BY_NAME[shape],
                        make_production_mesh())
    assert prod["memory"]["argument_bytes"] == dryrun.argument_bytes(cell, sizes("16x16"))


def test_shard_to_shard_traced_as_one_all_to_all(fake_group):
    """A shard-to-shard redistribution on a CPU mesh is traced as the one
    all-to-all a CUDA mesh runs (its input's bytes over the model axis),
    where DTensor alone would gather the whole dimension."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.analysis.hlo import CollectiveRecorder, Record

    mesh = make_fake_mesh((4, 2), ("data", "model"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = DTensor.from_local(torch.empty(4, 16), mesh, [Replicate(), Shard(0)],
                               run_check=False, shape=(8, 16), stride=(16, 1))
        with dryrun._exchanges_as_on_cuda(), CollectiveRecorder() as exchanged:
            y = x.redistribute(mesh, [Replicate(), Shard(1)])
        with CollectiveRecorder() as gathered:
            x.redistribute(mesh, [Replicate(), Shard(1)])
    assert y.to_local().shape == (8, 8)
    assert exchanged.records == [Record("all-to-all", 4 * 16 * 4, (0, 1))]
    assert gathered.records == [Record("all-gather", 8 * 16 * 4, (0, 1))]


def test_traced_peak_does_not_wait_for_the_collector(fake_group):
    """A decomposition that DTensor tries and drops while it propagates a
    reduced whisper prefill's cross-attention einsum must not keep the
    model's tensors alive until the cyclic collector runs: the traced peak
    is the same with the collector off as with it run at every chance."""
    import gc

    mesh = make_fake_mesh((4, 2), ("data", "model"))
    cell = S.build_cell(registry.reduced_config("whisper-large-v3"),
                        dataclasses.replace(SHAPE_BY_NAME["prefill_32k"], seq_len=64,
                                            global_batch=8), mesh)
    peaks = []
    threshold = gc.get_threshold()
    try:
        for off in (True, False):
            gc.collect()
            if off:
                gc.disable()
            else:
                gc.set_threshold(1, 1, 1)
            peaks.append(dryrun._trace_cell(cell, mesh)["memory"]["peak_bytes"])
            gc.enable()
            gc.set_threshold(*threshold)
    finally:
        gc.enable()
        gc.set_threshold(*threshold)
    assert peaks[0] == peaks[1], peaks


# ------------------------------------------------- the reduced train step --

def reduced():
    return dataclasses.replace(registry.reduced_config("qwen2-1.5b"), dtype="float32")


def stand_ins():
    return {"tokens": torch.full((B, S_LEN), 3, dtype=torch.int32),
            "labels": torch.full((B, S_LEN), 1, dtype=torch.int32)}


def reduced_cell(mesh):
    return S.build_cell(reduced(), dataclasses.replace(SHAPE_BY_NAME["train_4k"], seq_len=S_LEN,
                                                       global_batch=B), mesh)


def analytic_flops(cfg, b, s, ranks):
    """A rank's FLOPs of the unsharded step over ``ranks`` ranks: every
    matrix product 2 M N K forward and twice that backward (dX, dW), the
    attention kernels by their formulas (forward 4 D a pair, backward 14 D
    a pair, causal pairs), all split evenly."""
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.head_dim
    tok = b * s
    per_layer = 2 * tok * d * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd)   # q, k, v
    per_layer += 2 * tok * cfg.n_heads * hd * d                            # o
    per_layer += 3 * 2 * tok * d * f                                       # gate, up, down
    mm = cfg.n_layers * per_layer + 2 * tok * d * v                        # unembed
    pairs = s * (s + 1) // 2
    attn = cfg.n_layers * b * cfg.n_heads * pairs * hd * (4 + 14)
    return (3 * mm + attn) / ranks


def gloo_records(rank, world):
    """The reduced train step on 8 real gloo ranks -> rank's collective
    stats."""
    import warnings

    from repro_torch.analysis.hlo import CollectiveRecorder
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu", backend="gloo")
    st = S.make_sharded_train_step(reduced(), mesh, B, device="cpu")
    params, opt, batch = st.place(build_model(reduced(), device="cpu").init(0), stand_ins())
    with CollectiveRecorder() as rec:
        st(params, opt, batch)
    return rec.stats()


def test_reduced_step_flops_and_collectives(fake_group, tmp_path):
    mesh = make_fake_mesh((4, 2), ("data", "model"))
    traced = dryrun._trace_cell(reduced_cell(mesh), mesh)
    assert traced["cost"]["flops"] == analytic_flops(reduced(), B, S_LEN, 8)
    import torch.distributed as dist

    dist.destroy_process_group()
    real = run_ranks(gloo_records, 8, str(tmp_path), "gloo", timeout_s=300)
    assert traced["collectives"] == real[0]
    assert set(traced["collectives"]) >= {"all-gather", "all-reduce"}
