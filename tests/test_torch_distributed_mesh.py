"""Multi-device coadd jobs in the port on 8 and 4 gloo ranks, held against
the JAX package on 8 forced host devices.

Ports ``tests/test_distributed.py:26`` (the (4, 2) and (2, 2, 2) meshes,
sparse against dense) and ``tests/test_streaming.py:293`` (streamed mesh
windows and per-shard budgets on 8 shards): the port runs
`CoaddEngine.run_distributed` on 8 ranks started by
`repro_torch.launch.mesh.run_ranks` (spawned processes, a ``file://`` store
under ``tmp_path``), the reference in one subprocess with
``--xla_force_host_platform_device_count=8`` (as the reference's own tests
run it), each saving npz; the two run at once.  Every rank's results must
be bitwise rank 0's; rank 0's within 1e-2 of the reference's and of the
port's single-host ``run(q, "sql_structured")``, sparse within 1e-4 of
dense, depth exactly.  Also: the slab each rank holds against the shard
JAX's ``NamedSharding`` gives that mesh coordinate, `reducer.
reduce_collective` on 4 ranks against numpy sums (each query's own row
band), and ranks that plan different jobs raising instead of hanging.
The module imports no JAX: the spawned ranks import it.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.launch.mesh import make_mesh, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_runs=2, n_fields=4, n_sources=60, height=16, width=16)
QUERIES = (dict(band="r", ra_bounds=(37.2, 37.8), dec_bounds=(-0.5, 0.3), npix=32),
           dict(band="r", ra_bounds=(37.3, 37.7), dec_bounds=(-0.4, 0.2), npix=32))
TIMEOUT_S = 120
# The reference's subprocesses compile for 8 host devices; on a loaded
# several-worker run that can outlast the ranks' limit, so their wait has its own.
REFERENCE_TIMEOUT_S = 420
# name -> (mesh shape, mesh axes, data axes, engine options); "stream4" and
# "stream8" stream at a quarter and an eighth of the structured layout.
JOBS = {
    "42": ((4, 2), ("data", "model"), ("data",), {}),
    "222": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), {}),
    "dense": ((4, 2), ("data", "model"), ("data",), {"sparse": False}),
    "psf": ((4, 2), ("data", "model"), ("data",), {"match_psf_sigma": 2.0}),
    "stream4": ((4, 2), ("data", "model"), ("data",), {"budget_frac": 4}),
    "stream8": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), {"budget_frac": 8}),
}
STATS = ("packs_scanned", "packs_touched", "packs_gated", "scan_budget", "windows",
         "dispatches", "chunk_uploads", "files_considered", "files_contributing")

REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import CoaddEngine, CoaddQuery, SurveyConfig, make_survey
    from repro.distributed.sharding import shard_local_compaction
    out, cfg, queries, jobs, stats = sys.argv[1], *map(json.loads, sys.argv[2:6])
    sv = make_survey(SurveyConfig(**cfg))
    qs = [CoaddQuery(**q) for q in queries]
    ds = CoaddEngine(sv, pack_capacity=16).exec_dataset("structured")[0]
    arrays, meta = {}, {"stats": {}, "slabs": {}}
    for name, (shape, axes, data_axes, opts) in jobs.items():
        opts = dict(opts)
        frac = opts.pop("budget_frac", None)
        if frac:
            opts["device_budget_bytes"] = max(ds.chunk_nbytes(0, ds.n_packs) // frac, 1)
        mesh = jax.make_mesh(tuple(shape), tuple(axes))
        res = CoaddEngine(sv, pack_capacity=16, **opts).run_distributed(
            qs, mesh, data_axes=tuple(data_axes))
        for i, r in enumerate(res):
            arrays[f"{name}_{i}_c"], arrays[f"{name}_{i}_d"] = r.coadd, r.depth
        meta["stats"][name] = [{f: getattr(r.stats, f) for f in stats} for r in res]
        # The slab NamedSharding puts at each mesh coordinate.
        n = 64 * int(np.prod(shape))
        idx = NamedSharding(mesh, P(tuple(axes))).devices_indices_map((n,))
        coords = {d.id: [int(c) for c in np.argwhere(mesh.devices == d)[0]]
                  for d in mesh.devices.flat}
        meta["slabs"][name] = sorted([coords[d.id], s[0].start or 0, s[0].stop or n]
                                     for d, s in idx.items())
    gates = ds.flat_slot_mask(CoaddEngine(sv).sql.select(qs[0]), pad_to=ds.flat_len(8))
    meta["budgets"] = [int(b) for b in shard_local_compaction(gates, 8)[3]]
    np.savez(out, **arrays)
    with open(out + ".json", "w") as fh:
        json.dump(meta, fh)
''')


def distributed_rank(rank, world, out_dir):
    """One rank of the 8-rank run: every job of `JOBS`, its results to
    ``out_dir``; rank 0 also the single-host runs and the budgets."""
    torch.set_num_threads(1)
    survey = rt.make_survey(rt.SurveyConfig(**CFG))
    qs = [rt.CoaddQuery(**q) for q in QUERIES]
    eager = rt.CoaddEngine(survey, pack_capacity=16, device="cpu")
    ds = eager.exec_dataset("structured")[0]
    arrays, stats, meshes = {}, {}, {}
    for name, (shape, axes, data_axes, opts) in JOBS.items():
        opts = dict(opts)
        frac = opts.pop("budget_frac", None)
        if frac:
            # The reference's chunk bytes: the port's add each slot's flag byte.
            layout = ds.chunk_nbytes(0, ds.n_packs) - ds.n_packs * ds.capacity
            opts["device_budget_bytes"] = max(layout // frac, 1)
        key = (shape, axes)
        if key not in meshes:
            meshes[key] = make_mesh(shape, axes, device_type="cpu", backend="gloo")
        eng = rt.CoaddEngine(survey, pack_capacity=16, device="cpu", **opts)
        res = eng.run_distributed(qs, meshes[key], data_axes=data_axes)
        for i, r in enumerate(res):
            arrays[f"{name}_{i}_c"], arrays[f"{name}_{i}_d"] = r.coadd, r.depth
        stats[name] = [{f: getattr(r.stats, f) for f in STATS} for r in res]
        if name == "psf" and rank == 0:
            for i, q in enumerate(qs):
                r = eng.run(q, "sql_structured")
                arrays[f"single_psf_{i}_c"], arrays[f"single_psf_{i}_d"] = r.coadd, r.depth
        slab = eng._mesh_cache or None
        if slab:
            mds = next(iter(slab.values()))
            stats[name + "_slab"] = [int(mds.start), int(mds.start + mds.pixels.shape[0])]
    if rank == 0:
        for i, q in enumerate(qs):
            r = eager.run(q, "sql_structured")
            arrays[f"single_{i}_c"], arrays[f"single_{i}_d"] = r.coadd, r.depth
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    return stats


# The reference's jobs in two subprocesses (its dense and streamed jobs
# compile longest), beside the port's ranks.
REFERENCE_SPLIT = (("dense", "stream8"), ("42", "222", "psf", "stream4"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocesses and the port's 8 ranks, at once."""
    d = tmp_path_factory.mktemp("mesh8")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    outs = [str(d / f"ref{i}.npz") for i in range(len(REFERENCE_SPLIT))]
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, out, json.dumps(CFG), json.dumps(QUERIES),
         json.dumps({k: JOBS[k] for k in names}), json.dumps(STATS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for out, names in zip(outs, REFERENCE_SPLIT)]
    t0 = time.monotonic()
    try:
        stats = run_ranks(distributed_rank, 8, str(d), "gloo", args=(str(d),),
                          timeout_s=TIMEOUT_S)
        for ref in refs:
            out, err = ref.communicate(
                timeout=max(REFERENCE_TIMEOUT_S - (time.monotonic() - t0), 1))
            assert ref.returncode == 0, out + err
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    ranks = [np.load(str(d / f"rank{r}.npz")) for r in range(8)]
    arrays, meta = {}, {"stats": {}, "slabs": {}}
    for out in outs:
        with np.load(out) as z:
            arrays.update({k: z[k] for k in z.files})
        with open(out + ".json") as fh:
            part = json.load(fh)
        meta["stats"].update(part["stats"])
        meta["slabs"].update(part["slabs"])
        meta["budgets"] = part["budgets"]
    return dict(ref=arrays, meta=meta, ranks=ranks, stats=stats)


def _pair(z, name, i):
    return z[f"{name}_{i}_c"], z[f"{name}_{i}_d"]


def test_every_rank_returns_rank0_bitwise(runs):
    r0 = runs["ranks"][0]
    for r, z in enumerate(runs["ranks"][1:], 1):
        for k in z.files:
            assert np.array_equal(z[k].view(np.int32), r0[k].view(np.int32)), (r, k)
        assert ({k: v for k, v in runs["stats"][r].items() if not k.endswith("_slab")}
                == {k: v for k, v in runs["stats"][0].items() if not k.endswith("_slab")}), r


@pytest.mark.parametrize("name", sorted(JOBS))
def test_distributed_coadd_matches_reference_and_serial(runs, name):
    """tests/test_distributed.py:26 (and :293 for the streamed jobs): each
    job within 1e-2 of the reference's mesh and of the single-host run,
    depth exactly, stats as the reference counts them."""
    r0, ref = runs["ranks"][0], runs["ref"]
    single = "single_psf" if name == "psf" else "single"
    for i in range(len(QUERIES)):
        c, d = _pair(r0, name, i)
        rc_, rd = _pair(ref, name, i)
        sc, sd = _pair(r0, single, i)
        assert d.max() > 0
        assert np.abs(c - rc_).max() < 1e-2
        np.testing.assert_array_equal(d, rd)
        assert np.abs(c - sc).max() < 1e-2
        np.testing.assert_array_equal(d, sd)
        assert runs["stats"][0][name][i] == runs["meta"]["stats"][name][i]
    assert runs["stats"][0][name][0]["dispatches"] == runs["stats"][0][name][0]["windows"]


def test_sparse_matches_dense_and_scans_less(runs):
    """tests/test_distributed.py:44-51 on the (4, 2) mesh."""
    r0, st = runs["ranks"][0], runs["stats"][0]
    for i in range(len(QUERIES)):
        c, d = _pair(r0, "42", i)
        dc, dd = _pair(r0, "dense", i)
        assert np.abs(c - dc).max() < 1e-4
        np.testing.assert_array_equal(d, dd)
        assert st["42"][i]["packs_touched"] <= 8
    assert st["42"][0]["packs_scanned"] < st["dense"][0]["packs_scanned"]


def test_streamed_mesh_windows_and_shard_budgets(runs):
    """tests/test_streaming.py:293: the streamed jobs window the flat axis
    (more than one window at an eighth) and match eager; a band-gated
    selection gives the 8 shards unequal budgets."""
    r0, st = runs["ranks"][0], runs["stats"][0]
    assert st["stream8"][0]["windows"] > 1
    assert st["stream8"][0]["chunk_uploads"] == st["stream8"][0]["windows"]
    for name, eager in (("stream4", "42"), ("stream8", "222")):
        for i in range(len(QUERIES)):
            c, d = _pair(r0, name, i)
            ec, ed = _pair(r0, eager, i)
            assert np.abs(c - ec).max() < 1e-2
            np.testing.assert_array_equal(d, ed)
    budgets = np.array(runs["meta"]["budgets"])
    assert budgets.shape == (8,) and budgets.min() < budgets.max()
    assert int(budgets.sum()) < 8 * int(budgets.max())


@pytest.mark.parametrize("name", ["42", "222"])
def test_slab_order_matches_named_sharding(runs, name):
    """Each rank's slab is the one NamedSharding puts at its mesh
    coordinate: row-major over the shard axes in their order."""
    shape = JOBS[name][0]
    ref = {tuple(c): a // (b - a) for c, a, b in runs["meta"]["slabs"][name]}
    assert sorted(ref.values()) == list(range(8))
    for r in range(8):
        a, b = runs["stats"][r][name + "_slab"]
        coord = tuple(int(c) for c in np.unravel_index(r, shape))
        assert a // (b - a) == ref[coord], (r, coord)


# ----- reduce_collective on 4 ranks -------------------------------------------

COLLECTIVE_MESHES = {
    "data_model": ((2, 2), ("data", "model"), ("data",), "model"),
    "data_only": ((4,), ("data",), ("data",), None),
    "pod_data_model": ((2, 1, 2), ("pod", "data", "model"), ("pod", "data"), "model"),
    "model_only": ((1, 4), ("data", "model"), (), "model"),
}


def _partials(rank):
    rng = np.random.default_rng(rank)
    return (rng.standard_normal((3, 8, 8)).astype(np.float32),
            rng.random((3, 8, 8)).astype(np.float32))


def collective_rank(rank, world):
    from repro_torch.core import reducer

    out = {}
    for name, (shape, axes, data_axes, model) in COLLECTIVE_MESHES.items():
        mesh = make_mesh(shape, axes, device_type="cpu", backend="gloo")
        c, d = (torch.from_numpy(x) for x in _partials(rank))
        bc, bd = reducer.reduce_collective(c, d, mesh, data_axes, model)
        fc, fd = reducer.gather_collective(bc, bd, mesh, model)
        out[name] = (mesh.get_coordinate(), bc.numpy().copy(), bd.numpy().copy(),
                     fc.numpy().copy(), fd.numpy().copy())
    return out


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return run_ranks(collective_rank, 4, str(tmp_path_factory.mktemp("coll4")), "gloo",
                     timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("name", sorted(COLLECTIVE_MESHES))
def test_reduce_collective_bands_against_numpy(collectives, name):
    """All-reduce over the data axes, reduce-scatter of each query's rows
    over the model axis (shard j owns rows [j*8/m, (j+1)*8/m) of every
    query), then the all-gather: every rank against numpy sums."""
    shape, axes, data_axes, model = COLLECTIVE_MESHES[name]
    coords = [tuple(int(c) for c in np.unravel_index(r, shape)) for r in range(4)]
    summed = set(data_axes) | ({model} if model else set())
    for r in range(4):
        coord, bc, bd, fc, fd = collectives[r][name]
        assert tuple(coord) == coords[r]
        peers = [p for p in range(4)
                 if all(coords[p][i] == coords[r][i] for i, a in enumerate(axes)
                        if a not in summed)]
        want_c = np.sum([_partials(p)[0] for p in peers], axis=0, dtype=np.float64)
        want_d = np.sum([_partials(p)[1] for p in peers], axis=0, dtype=np.float64)
        np.testing.assert_allclose(fc, want_c, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fd, want_d, rtol=1e-6, atol=1e-6)
        if model is None:
            np.testing.assert_array_equal(bc, fc)
            continue
        m = shape[axes.index(model)]
        j = coord[axes.index(model)]
        rows = slice(j * 8 // m, (j + 1) * 8 // m)
        assert bc.shape == (3, 8 // m, 8)
        np.testing.assert_array_equal(bc, fc[:, rows])
        np.testing.assert_array_equal(bd, fd[:, rows])


# ----- ranks that planned different jobs ----------------------------------------

def disagreeing_rank(rank, world):
    torch.set_num_threads(1)
    survey = rt.make_survey(rt.SurveyConfig(**CFG))
    q = dict(QUERIES[0], ra_bounds=(37.2, 37.8 - 0.2 * rank))
    mesh = make_mesh((world, 1), ("data", "model"), device_type="cpu", backend="gloo")
    rt.CoaddEngine(survey, pack_capacity=16, device="cpu").run_distributed(
        [rt.CoaddQuery(**q)], mesh)


def test_ranks_that_plan_different_jobs_raise(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planned another job"):
        run_ranks(disagreeing_rank, 2, str(tmp_path), "gloo", timeout_s=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S
