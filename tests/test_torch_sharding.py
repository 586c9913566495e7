"""The LM sharding rules of the port against the JAX package's.

`repro_torch.distributed.sharding`'s LM half (``param_pspecs`` plain and
``pure_dp``, ``strip_axis``, ``batch_pspec``, ``cache_pspec``) must give,
entry for entry, the ``PartitionSpec`` trees of ``repro.distributed.
sharding`` for every configuration at full size: the reference's trees
from ``jax.eval_shape(model.init)`` on ``jax.sharding.AbstractMesh`` (no
devices), the port's from its `LM` on the ``meta`` device and a plain
``{axis: size}`` mapping.  Meshes: 16 x 16 (data, model), 2 x 16 x 16
(pod, data, model), 4 x 2 and 2 x 2 x 2.

On 8 gloo CPU ranks, a leaf placed by a spec with a tuple entry gives each
rank the slice that row-major order over the tuple's axes assigns to its
mesh coordinate (what ``NamedSharding`` assigns), DTensor's own view of
the placements agrees (also with its all-gathers carried by the eager
collective, `sharding.route_all_gather`), and a tuple out of the mesh's
order raises.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import registry as ref_registry
from repro.distributed import sharding as ref_sharding
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.model import LM
from repro_torch.optim.adamw import tree_leaves

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
BATCHES = (1, 2, 8, 32, 128, 256, 512, 6)
CACHE = ((128, 4096), (1, 32768), (32, 1000))


@functools.lru_cache(maxsize=None)
def ref_shapes(arch):
    model = ref_build_model(ref_registry.get_config(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_shapes(arch):
    return LM(registry.get_config(arch), device="meta").init()


def ref_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def port_mesh(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def ref_tree(specs):
    """{path: spec as a tuple} of a reference spec tree."""
    leaves = jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(k.key for k in path): tuple(spec) for path, spec in leaves}


def port_tree(specs):
    return {path: spec for path, spec in tree_leaves(specs)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    """param_pspecs plain and pure_dp, and strip_axis of each, entry for entry."""
    rshape, pshape = ref_shapes(arch), port_shapes(arch)
    want_shapes = {"/".join(k.key for k in path): tuple(leaf.shape)
                   for path, leaf in jax.tree_util.tree_leaves_with_path(rshape)}
    assert {p: tuple(x.shape) for p, x in tree_leaves(pshape)} == want_shapes
    rm, pm = ref_mesh(mesh), port_mesh(mesh)
    for pure_dp in (False, True):
        want = ref_sharding.param_pspecs(rshape, rm, pure_dp=pure_dp)
        got = sharding.param_pspecs(pshape, pm, pure_dp=pure_dp)
        assert port_tree(got) == ref_tree(want), (arch, mesh, pure_dp)
        for axis in ("data", "model"):
            assert (port_tree(sharding.strip_axis(got, axis))
                    == ref_tree(ref_sharding.strip_axis(want, axis))), (arch, mesh, axis)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_cache_specs_match_reference(mesh):
    """batch_pspec at several global batches and extra dims, plain and
    pure_dp; cache_pspec on every configuration's stacked KV leaves."""
    rm, pm = ref_mesh(mesh), port_mesh(mesh)
    for b in BATCHES:
        for extra in (1, 2):
            for pure_dp in (False, True):
                assert (sharding.batch_pspec(pm, b, extra, pure_dp)
                        == tuple(ref_sharding.batch_pspec(rm, b, extra, pure_dp))), (b, extra)
    assert sharding.dp_axes(pm) == ref_sharding.dp_axes(rm)
    n = 0
    for arch in registry.ARCH_IDS:
        model = ref_build_model(ref_registry.get_config(arch))
        for batch, max_len in CACHE:
            cache = jax.eval_shape(lambda: model.init_cache(batch, max_len))
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
                if path[-1].key in ("k", "v", "cross_k", "cross_v") and leaf.ndim == 5:
                    want = ref_sharding.cache_pspec(rm, batch, leaf.shape, seq_axis=2)
                    got = sharding.cache_pspec(pm, batch, tuple(leaf.shape), seq_axis=2)
                    assert got == tuple(want), (arch, path, batch, max_len)
                    n += 1
    assert n > 0


def test_spec_entries_normalize_as_partition_spec():
    """A one-axis tuple is stored as its name (PartitionSpec's form), several
    axes as the tuple, none as None."""
    pm = port_mesh("2x2x2")
    assert sharding.batch_pspec(pm, 4) == (("pod", "data"), None)
    assert sharding.batch_pspec(pm, 2) == ("data", None)
    assert sharding.batch_pspec(pm, 3) == (None, None)
    assert sharding.strip_axis({"w": (("data", "model"), None)})["w"] == ("model", None)
    assert sharding.strip_axis({"w": ("data", "model")})["w"] == (None, "model")


# ---------------------------------------------------------------- on ranks --

# spec -> the leaf's shape; every entry a tuple over the (2, 2, 2) mesh.
PLACED = {
    (("pod", "data", "model"), None): (16, 3),
    (("data", "model"), None): (8, 5),
    (("pod", "model"), "data"): (4, 6),
    (None, ("pod", "data")): (3, 8),
    ("model", ("pod", "data")): (4, 4),
}


def expected_slice(full, spec, coord, names, sizes):
    """Row-major over each entry's axes in the entry's order (numpy)."""
    out = full
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        if not axes:
            continue
        idx = np.ravel_multi_index([coord[names.index(a)] for a in axes],
                                   [sizes[names.index(a)] for a in axes])
        n = int(np.prod([sizes[names.index(a)] for a in axes]))
        out = np.split(out, n, axis=dim)[idx]
    return out


def placed_rank(rank, world):
    torch.set_num_threads(1)
    shape, names = MESHES["2x2x2"]
    mesh = make_mesh(shape, names, device_type="cpu", backend="gloo")
    coord = list(mesh.get_coordinate())
    assert coord == list(np.unravel_index(rank, shape))
    out = {}
    for spec, leaf_shape in PLACED.items():
        full = np.arange(np.prod(leaf_shape), dtype=np.float32).reshape(leaf_shape)
        d = sharding.distribute(torch.from_numpy(full), spec, mesh)
        want = expected_slice(full, spec, coord, list(names), list(shape))
        out[str(spec)] = (np.array_equal(d.to_local().numpy(), want),
                          np.array_equal(d.full_tensor().numpy(), full),
                          np.array_equal(sharding.local_part(torch.from_numpy(full), spec,
                                                             mesh).numpy(), want))
    # DTensor's all-gathers carried by the eager collective, as on a gloo
    # group of CUDA tensors (here registered for CPU tensors).
    sharding.route_all_gather("cpu")
    for spec, leaf_shape in PLACED.items():
        full = np.arange(np.prod(leaf_shape), dtype=np.float32).reshape(leaf_shape) * 0.5
        d = sharding.distribute(torch.from_numpy(full), spec, mesh)
        out["routed " + str(spec)] = np.array_equal(d.full_tensor().numpy(), full)
    for bad in ((("model", "data"), None), (("data", "pod"), None), ("data", "data")):
        try:
            sharding.placements(bad, mesh)
            out[str(bad)] = "placed"
        except ValueError:
            out[str(bad)] = "raised"
    return out


def test_tuple_entries_split_row_major_on_ranks(tmp_path):
    outs = run_ranks(placed_rank, 8, str(tmp_path), "gloo", timeout_s=300)
    for rank, out in enumerate(outs):
        for spec in PLACED:
            local_ok, full_ok, part_ok = out[str(spec)]
            assert local_ok and part_ok, (rank, spec)
            assert full_ok and out["routed " + str(spec)], (rank, spec)
        assert out[str((("model", "data"), None))] == "raised"
        assert out[str((("data", "pod"), None))] == "raised"
        assert out[str(("data", "data"))] == "raised"
