"""The port's train step sharded on a device mesh (DTensor), on 8 gloo CPU ranks.

The port of ``tests/test_distributed.py:57``: the reduced qwen2-1.5b in
float32 on a (4, 2) ("data", "model") mesh, the parameters placed by the
port's sharding rules, tokens of 3 and labels of 1 in an 8 x 16 batch, two
steps of `make_sharded_train_step` against the same steps of the unsharded
`make_train_step` (parameters within 1e-4, loss within 1e-5, the reference
test's bounds).  The same for every branch of the rules: the reduced
granite-moe-3b-a800m (the token-local MoE over (data, model), its aux loss
equal to the unsharded one's), mamba2-130m (``pure_dp``), qwen2-72b (zero1
and sequence-parallel activations) and zamba2-1.2b (the SSD and the shared
attention under TP), mixtral-8x7b (the token-local ``shard_map`` MoE over
(data, model) and the sliding window), and qwen2-1.5b on a (2, 2, 2)
("pod", "data", "model") mesh.  On every rank: the loss bitwise rank 0's, every parameter,
m and v in its spec's placements after each step (step replicated), every
gradient reaching ``adamw_update`` in its parameter's placements (a spy),
the kernels' wrappers run on local shards (their plain versions here, with
the local shapes recorded).  Also: the MoE layer alone on random rows
against `moe.moe_apply_grouped`, `global_norm` of DTensors, and
``adamw_update`` refusing a partial gradient.

The unsharded step itself is held against the JAX package's jitted step on
the same weights (``tests/test_torch_train_drill.py``'s bounds).  The 8
ranks are spawned once for both meshes and every case; they import this
module, so the JAX package is imported only where the reference runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.launch.specs import act_axes, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init, tree_leaves

# name -> (arch, config overrides); the reference test's reduced qwen2 first.
CASES = {
    "qwen2": ("qwen2-1.5b", {}),
    "granite": ("granite-moe-3b-a800m", {}),
    "mamba2": ("mamba2-130m", {}),
    "qwen2-72b": ("qwen2-72b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "mixtral": ("mixtral-8x7b", {}),
}
MESHES = {"4x2": ((4, 2), ("data", "model"), tuple(CASES)),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), ("qwen2",))}
WORLD = 8
STEPS = 2
TOKENS, LABELS = 3, 1
B, S = 8, 16
TIMEOUT_S = 600


def config(name):
    """The reduced config in float32, with remat (its units under
    torch.utils.checkpoint on DTensors, as the full configs train)."""
    arch, over = CASES[name]
    return dataclasses.replace(registry.reduced_config(arch), dtype="float32", remat=True,
                               **over)


def batch():
    return {"tokens": torch.full((B, S), TOKENS, dtype=torch.int32),
            "labels": torch.full((B, S), LABELS, dtype=torch.int32)}


def ref_params(name):
    import jax

    from repro.configs import registry as ref_registry
    from repro.models.model import build_model as ref_build_model

    arch, over = CASES[name]
    cfg = dataclasses.replace(ref_registry.reduced_config(arch), dtype="float32", **over)
    return jax.tree.map(np.asarray, ref_build_model(cfg).init(jax.random.PRNGKey(0)))


def unsharded_runs(name, mesh_sizes, weights):
    """STEPS steps of the port's unsharded step -> [(loss, grad norm, {path:
    params numpy})]; zero1 with the mesh's stripped specs."""
    cfg = config(name)
    params = convert.lm_params_from_reference(weights)
    compute = (sharding.strip_axis(sharding.param_pspecs(params, mesh_sizes))
               if cfg.param_mode == "zero1" else None)
    step = make_train_step(build_model(cfg, device="cpu"), compute_pspecs=compute)
    opt = adamw_init(params)
    out = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, batch())
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {p: x.detach().numpy().copy() for p, x in tree_leaves(params)}))
    return out


# ------------------------------------------------------------------ ranks --

def _spies(box):
    """Wrap the kernels' CPU paths to record in box["calls"] the shapes each
    call sees, and the step's adamw_update to record in box["seen"] whether
    every gradient arrives in its parameter's placements (none partial)."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import specs

    fwd, ssd_ref, update = flash_ops._forward, ssd_ops.ref.ssd_chunked_ref, specs.adamw_update

    def flash(q, k, v, *args, **kwargs):
        box["calls"].setdefault("flash", set()).add((tuple(q.shape), tuple(k.shape)))
        return fwd(q, k, v, *args, **kwargs)

    def ssd(log_a, Bm, Cm, x, *args, **kwargs):
        box["calls"].setdefault("ssd", set()).add((tuple(x.shape), tuple(Bm.shape)))
        return ssd_ref(log_a, Bm, Cm, x, *args, **kwargs)

    def spy(grads, state, params, cfg):
        box["seen"].append(all(
            g.placements == p.placements and not any(x.is_partial() for x in g.placements)
            for (_, g), (_, p) in zip(tree_leaves(grads), tree_leaves(params))))
        return update(grads, state, params, cfg)

    flash_ops._forward = flash
    ssd_ops.ref.ssd_chunked_ref = ssd
    specs.adamw_update = spy


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _placed(st, params, opt, mesh):
    want = sharding.named_shardings(st.pspecs, mesh)
    return (all(x.placements == tuple(_get(want, p))
                for tree in (params, opt["m"], opt["v"]) for p, x in tree_leaves(tree))
            and all(x.is_replicate() for x in opt["step"].placements))


def _moe_alone(mesh, cfg, weights):
    """The MoE layer alone on random rows: the token-local DTensor run
    against moe_apply_grouped on the whole batch."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(cfg, act_shard_axes=act_axes(cfg, mesh, B))
    p = {k: torch.from_numpy(np.asarray(v[0])) for k, v in weights["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    groups = int(np.prod([dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[a]
                          for a in cfg.act_shard_axes]))
    want_out, want_aux = moe.moe_apply_grouped(p, x, cfg, groups)
    dp = {k: sharding.distribute(v, (None,) * v.ndim, mesh) for k, v in p.items()}
    got_out, got_aux = moe.moe_apply(dp, sharding.distribute(x, ("data", None, None), mesh), cfg)
    return (float((got_out.full_tensor() - want_out).abs().max()),
            abs(float(got_aux.full_tensor()) - float(want_aux)), float(want_aux),
            abs(float(moe.moe_apply_scatter(p, x, cfg)[1]) - float(want_aux)))


def ranks_main(rank, world, weights, unsharded):
    """Every mesh of MESHES on the same 8 ranks -> {mesh: {case: record}}."""
    box = {}
    _spies(box)
    return {m: mesh_rank(shape, axes, names, weights, unsharded[m], box)
            for m, (shape, axes, names) in MESHES.items()}


def mesh_rank(shape, axes, names, weights, unsharded, box):
    import warnings

    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.specs import make_sharded_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm

    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    mesh = make_mesh(shape, axes, device_type="cpu", backend="gloo")
    out = {}
    for name in names:
        calls, seen = box["calls"], box["seen"] = {}, []
        st = make_sharded_train_step(config(name), mesh, B, device="cpu")
        params, opt, bt = st.place(convert.lm_params_from_reference(weights[name]), batch())
        rec = dict(losses=[], grad_norms=[], max_diff=[], placed=[])
        for i in range(STEPS):
            params, opt, m = st(params, opt, bt)
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            want = unsharded[name][i][2]
            rec["max_diff"].append(max(
                float((x.to_local() - sharding.local_part(
                    torch.from_numpy(want[p]), _get(st.pspecs, p), mesh)).abs().max())
                for p, x in tree_leaves(params)))
            rec["placed"].append(_placed(st, params, opt, mesh))
        rec["grads_placed"] = seen
        rec["calls"] = {k: sorted(v) for k, v in calls.items()}
        rec["act_axes"] = st.model.cfg.act_shard_axes
        if name == "granite":
            cfg = config(name)
            with implicit_replication(), torch.no_grad():
                _, aux = st.model.forward(params, bt)
            plain = build_model(cfg, device="cpu")
            full = _untree({p: x.full_tensor() for p, x in tree_leaves(params)})
            _, aux_plain = plain.forward(full, batch())
            rec["aux"] = (float(aux.full_tensor()), float(aux_plain))
            rec["moe_alone"] = _moe_alone(mesh, cfg, weights[name])
        if name == "qwen2" and len(shape) == 2:
            gn = global_norm(opt["m"])
            full = torch.sqrt(sum(torch.sum(x.full_tensor() ** 2)
                                  for _, x in tree_leaves(opt["m"])))
            rec["norm"] = (float(gn.to_local()), float(full),
                           all(x.is_replicate() for x in gn.placements))
            grads = _untree({p: x.detach().clone() for p, x in tree_leaves(params)})
            scale = grads["ln_f"]["scale"]   # replicated: its partial sums are the trap
            grads["ln_f"]["scale"] = DTensor.from_local(scale.to_local(), mesh,
                                                        [Partial(), Replicate()])
            try:
                adamw_update(grads, opt, params, AdamWConfig())
                rec["partial_refused"] = False
            except ValueError:
                rec["partial_refused"] = True
        out[name] = rec
    return out


def _untree(flat):
    tree = {}
    for p, x in flat.items():
        node = tree
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


# ------------------------------------------------------------------ tests --

@pytest.fixture(scope="module")
def weights():
    return {name: ref_params(name) for name in CASES}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """Both meshes' runs on one spawn of 8 ranks -> {mesh: its run}."""
    unsharded = {m: {n: unsharded_runs(n, dict(zip(axes, shape)), weights[n]) for n in names}
                 for m, (shape, axes, names) in MESHES.items()}
    outs = run_ranks(ranks_main, WORLD, str(tmp_path_factory.mktemp("sharded")), "gloo",
                     args=(weights, unsharded), timeout_s=TIMEOUT_S)
    return {m: dict(mesh=m, sizes=dict(zip(axes, shape)), names=names,
                    outs=[o[m] for o in outs], unsharded=unsharded[m])
            for m, (shape, axes, names) in MESHES.items()}


@pytest.fixture(params=list(MESHES))
def mesh_run(request, runs):
    return runs[request.param]


def test_sharded_step_matches_unsharded(mesh_run):
    """Parameters within 1e-4 and loss within 1e-5 of the unsharded step
    after each step (tests/test_distributed.py:85-87), every case."""
    for name in mesh_run["names"]:
        rec = mesh_run["outs"][0][name]
        for i, (loss, gn, _) in enumerate(mesh_run["unsharded"][name]):
            assert abs(rec["losses"][i] - loss) < 1e-5, (name, i, rec["losses"][i], loss)
            np.testing.assert_allclose(rec["grad_norms"][i], gn, rtol=1e-4)
            worst = max(r[name]["max_diff"][i] for r in mesh_run["outs"])
            assert worst < 1e-4, (name, i, worst)


def test_every_rank_bitwise_rank0_and_placed(mesh_run):
    outs = mesh_run["outs"]
    for name in mesh_run["names"]:
        for r, out in enumerate(outs):
            rec = out[name]
            assert rec["losses"] == outs[0][name]["losses"], (name, r)
            assert rec["grad_norms"] == outs[0][name]["grad_norms"], (name, r)
            assert all(rec["placed"]), (name, r)
            assert rec["grads_placed"] == [True] * STEPS, (name, r)


def test_act_axes_and_local_kernel_shapes(mesh_run):
    """The act-axes rule, and the kernels' calls on local shards: batch over
    the act axes, heads over model where they divide (GQA ratio kept)."""
    sizes = mesh_run["sizes"]
    for name in mesh_run["names"]:
        cfg = config(name)
        rec = mesh_run["outs"][0][name]
        want_axes = tuple(a for a in ("pod", "data") if a in sizes)
        if cfg.pure_dp or cfg.moe_impl == "shard_map":
            want_axes += ("model",)
        assert tuple(rec["act_axes"]) == want_axes == act_axes(cfg, sizes, B)
        rows = B // int(np.prod([sizes[a] for a in want_axes]))
        m = 1 if "model" in want_axes else sizes["model"]
        if cfg.n_heads and cfg.family != "ssm":
            q = (rows, cfg.n_heads // m, S, cfg.head_dim)
            k = (rows, cfg.n_kv_heads // m, S, cfg.head_dim)
            assert rec["calls"]["flash"] == [(q, k)], (name, rec["calls"])
        if cfg.family in ("ssm", "hybrid"):
            x = (rows, S, cfg.n_ssm_heads // m, cfg.ssm_head_dim)
            assert rec["calls"]["ssd"] == [(x, (rows, S, cfg.ssm_state))], (name, rec["calls"])


def test_token_local_moe(runs):
    """The sharded MoE's aux loss equals the unsharded one on the reference
    test's batch; alone on random rows it is moe_apply_grouped over the
    shards' row groups (outputs and aux), whose aux differs from the
    whole-batch aux there."""
    for out in runs["4x2"]["outs"]:
        aux, aux_plain = out["granite"]["aux"]
        assert abs(aux - aux_plain) <= 1e-6 * abs(aux_plain), (aux, aux_plain)
        out_diff, aux_diff, aux_want, whole_diff = out["granite"]["moe_alone"]
        assert out_diff < 1e-5 and aux_diff <= 1e-6 * abs(aux_want), (out_diff, aux_diff)
        assert whole_diff > 1e-6


def test_global_norm_and_partial_gradient_refused(runs):
    """global_norm of DTensors: the full tree's norm, replicated; and
    adamw_update refuses a gradient left as partial sums."""
    for out in runs["4x2"]["outs"]:
        got, full, replicated = out["qwen2"]["norm"]
        assert replicated and abs(got - full) <= 1e-6 * full
        assert out["qwen2"]["partial_refused"]


@pytest.mark.parametrize("name", list(CASES))
def test_unsharded_step_matches_reference_jitted_step(name, weights):
    """The port's unsharded step against the JAX package's jitted step on the
    same weights (zero1 on a (1, 1) mesh of auto axes, which its
    with_sharding_constraint needs)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import registry as ref_registry
    from repro.distributed import sharding as ref_sharding
    from repro.launch import specs as ref_specs
    from repro.models.model import build_model as ref_build_model
    from repro.optim import adamw as ref_adamw

    arch, over = CASES[name]
    cfg = dataclasses.replace(ref_registry.reduced_config(arch), dtype="float32", **over)
    rp = jax.tree.map(jnp.asarray, weights[name])
    ro = ref_adamw.adamw_init(rp)
    jb = {"tokens": jnp.full((B, S), TOKENS, jnp.int32), "labels": jnp.full((B, S), LABELS,
                                                                           jnp.int32)}
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    compute = (ref_sharding.strip_axis(ref_sharding.param_pspecs(
        jax.eval_shape(lambda: rp), mesh)) if cfg.param_mode == "zero1" else None)
    ref_step = jax.jit(ref_specs.make_train_step(ref_build_model(cfg), compute_pspecs=compute))
    sizes = {"data": 4, "model": 2}
    runs = unsharded_runs(name, sizes, weights[name])
    with mesh:
        for i in range(STEPS):
            rp, ro, rm = ref_step(rp, ro, jb)
            loss, gn, params = runs[i]
            assert abs(loss - float(rm["loss"])) < 1e-5, (name, i)
            np.testing.assert_allclose(gn, float(rm["grad_norm"]), rtol=1e-4)
    want = dict(tree_leaves(jax.tree.map(np.asarray, rp)))
    d = max(float(np.abs(x - want[p]).max()) for p, x in runs[-1][2].items())
    assert d < 1e-4, (name, d)
