"""Dry run: trace every (arch x shape x mesh) cell at full size in one process.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for a 256- or 512-chip mesh.  Here each cell is run once
as rank 0 of the production mesh (`launch.mesh.make_production_mesh`: a
fake process group of 256 or 512 ranks) under ``FakeTensorMode``: every
tensor has a shape, a dtype and a device but no memory, every collective
returns a tensor of the right shape and moves nothing, and the hand-written
kernels run their fake versions (``repro_torch::flash_fwd`` and the other
kernel operators).  `_trace_cell` records, for that one rank:

* ``memory``: ``argument_bytes`` (the local shards of the step's inputs),
  ``output_bytes`` (of its outputs), ``peak_bytes`` (the most bytes of
  tensor storage alive at once while the step ran, its arguments included:
  each storage counted from the operation that makes it until it is freed)
  and ``temp_bytes`` = peak - arguments;
* ``cost``: ``flops``, the FLOP counts of ``torch.utils.flop_counter``'s
  formulas (matrix products) and of the kernels' own formulas, on the local
  shapes each operation sees (a rank's own work, not the global operation);
  ``bytes_accessed``, each operation's input and output bytes, unfused
  (views, allocations and collectives move none);
* ``collectives``: this rank's collectives by kind (`analysis.hlo`);
* ``trace_s``: the trace's seconds.

DTensor's sharding propagation runs each operation once more on global
shapes to learn its output's; those runs are not counted, nor are
operations on ``meta`` tensors (shapes only).  The schema is
the reference's (``lower_s`` and ``compile_s`` give way to ``trace_s``).

The port unrolls its layers, so the full-depth trace needs no scaling; the
reference's cost probes (`_probe_cfgs`, `_scale_costs`) are kept as a
cross-check: the scaled probes equal the full trace.  A decode step's
position, a 0-d stand-in, is traced at 0 (its value moves no shape).  A
trace on a ``"cpu"`` mesh is the trace of the card's program: DTensor does
a shard-to-shard redistribution of CPU tensors as an all-gather of the whole
dimension and a chunk (gloo has no all-to-all), and the trace runs it as a
CUDA mesh does, one all-to-all (`_exchanges_as_on_cuda`).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out-dir experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch.analysis.hlo import CollectiveRecorder


class CellTrace(CollectiveRecorder):
    """The dry run's ``TorchDispatchMode``: beneath DTensor (a DTensor
    operation is passed on, its local operations come back through the
    mode), it adds up FLOPs and bytes, follows the live bytes of every
    storage the operations make, and records collectives.  ``arguments``
    are the step's inputs' local tensors, alive from the start."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._propagating = 0
        for t in arguments:
            self._track(t)

    def _track(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if (not self._propagating and func._overloadpacket not in flop_registry
                and func is not torch.ops.prim.device.default):
            # A composite (aten.matmul) as the operations it is made of,
            # each through the mode (torch's FlopCounterMode does the same).
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._propagating or _on_meta(args, out):
            return out
        if self.record(func, args, out) is None and func.namespace != "_c10d_functional":
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
            if not func.is_view and not packet.__name__.startswith("empty"):
                self.bytes_accessed += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            self._track(t)
        return out

    @contextlib.contextmanager
    def uncounted_propagation(self):
        """DTensor's own work left out of the counts: its sharding
        propagation (the strategies and the output-shape runs on global
        shapes, ``ShardingPropagator``), its redistribution planning and a
        strided shard's offsets (``_StridedShard``: a 2 x 16 x 16 step's
        flattened rows).  These run outside ``FakeTensorMode`` (the shape
        runs under a mode of their own), as they would with real tensors:
        their small index tensors must hold values.

        A strategy's decomposition that fails is caught by DTensor and kept
        in a local of the frame that caught it: that frame and its traceback
        hold each other, and with them the model's frames above, whose
        tensors then live until the cyclic collector runs, at a point that
        moves with the hash seed (a traced peak 30.7 or 52.0 GiB for one
        cell).  Each such failure's traceback is dropped when the
        propagation returns, so that the tensors die with their last use,
        as they would without the failure."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import _redistribute, placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        try:
            from torch.distributed.tensor._decompositions import DecompShardingStrategy
        except ImportError:
            DecompShardingStrategy = None
        failures = []

        def wrap(inner, unfake):
            def call(*args, **kwargs):
                self._propagating += 1
                try:
                    with unset_fake_temporarily() if unfake else contextlib.nullcontext():
                        return inner(*args, **kwargs)
                finally:
                    self._propagating -= 1
                    if not self._propagating:
                        for e in failures:
                            e.__traceback__ = None
                        failures.clear()
            return call

        def kept(inner, _):
            def call(*args, **kwargs):
                try:
                    return inner(*args, **kwargs)
                except Exception as e:
                    failures.append(e)
                    raise
            return call

        patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached", False, wrap),
                   (ShardingPropagator, "propagate_op_sharding_non_cached", True, wrap),
                   (_redistribute, "_gen_transform_infos_non_cached", True, wrap),
                   (getattr(placement_types, "_StridedShard", None),
                    "local_shard_size_and_offset", True, wrap),
                   (DecompShardingStrategy, "propagate_strategy", False, kept)]
        saved = [(owner, name, getattr(owner, name), unfake, how)
                 for owner, name, unfake, how in patches
                 if owner is not None and hasattr(owner, name)]
        if not saved or saved[0][1] != "_propagate_tensor_meta_non_cached":
            raise RuntimeError("this torch's DTensor has no ShardingPropagator."
                               "_propagate_tensor_meta_non_cached to leave out")
        for owner, name, inner, unfake, how in saved:
            setattr(owner, name, how(inner, unfake))
        try:
            yield
        finally:
            for owner, name, inner, _, _ in saved:
                setattr(owner, name, inner)


def _on_meta(args, out) -> bool:
    """Whether an operation works on ``meta`` tensors (shapes, no memory:
    `LM.init_cache` takes a cache's shapes so)."""
    from torch.utils._pytree import tree_leaves

    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in tree_leaves((args, out)))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def argument_bytes(cell, mesh) -> int:
    """Per-device bytes of a cell's arguments: each stand-in's shard under
    its spec (``mesh`` a `DeviceMesh` or ``{axis: size}``)."""
    from repro_torch.distributed import sharding

    total = 0
    for arg, spec in zip(cell.args, cell.in_shardings):
        for t, s in _paired(arg, spec):
            total += int(torch.Size(sharding.shard_shape(t.shape, s, mesh)).numel()
                         * t.element_size())
    return total


def _paired(tree, specs):
    """(stand-in, spec) of every leaf of an argument tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paired(v, specs[k])
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def _materialize(arg, spec, mesh):
    """A stand-in tree as DTensors placed by its specs, each shard an empty
    tensor on the mesh's device (fake under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding

    if isinstance(arg, dict):
        return {k: _materialize(v, spec[k], mesh) for k, v in arg.items()}
    if not isinstance(arg, torch.Tensor):
        return arg
    local = torch.empty(sharding.shard_shape(arg.shape, spec, mesh), dtype=arg.dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, sharding.placements(spec, mesh), run_check=False,
                              shape=arg.shape, stride=arg.stride())


@contextlib.contextmanager
def _exchanges_as_on_cuda():
    """Every shard-to-shard redistribution as the one all-to-all that DTensor
    runs on a CUDA mesh (``_dtensor.shard_dim_alltoall``, whose fake
    version runs on any device), also on a CPU mesh, where DTensor would
    gather the whole dimension: n times the link bytes and a buffer n times
    the shard.  Under ``FakeTensorMode`` only."""
    from torch.distributed.tensor import _collective_utils, placement_types

    original = _collective_utils.shard_dim_alltoall

    def exchange(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                     mesh.get_group(mesh_dim).group_name)

    owners = [m for m in (_collective_utils, placement_types)
              if getattr(m, "shard_dim_alltoall", None) is original]
    for m in owners:
        m.shard_dim_alltoall = exchange
    try:
        yield
    finally:
        for m in owners:
            m.shard_dim_alltoall = original


def _trace_cell(cell, mesh) -> Dict:
    """Run ``cell`` once as rank 0 of ``mesh`` under ``FakeTensorMode`` ->
    {trace_s, memory, cost, collectives} (the module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    def position(a):
        return isinstance(a, torch.Tensor) and a.ndim == 0 and not a.is_floating_point()

    # A position stands in as a Python int; its 4 bytes count as the reference's.
    scalars = sum(a.element_size() for a in cell.args if position(a))
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [0 if position(a) else _materialize(a, s, mesh)
                for a, s in zip(cell.args, cell.in_shardings)]
        locals_ = [t.to_local() for t in tree_leaves(args) if isinstance(t, DTensor)]
        trace = CellTrace(locals_)
        arg_bytes = trace.live + scalars
        del locals_
        t0 = time.perf_counter()
        with _exchanges_as_on_cuda(), trace.uncounted_propagation(), trace:
            out = cell.fn(*args)
        seconds = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    return {
        "trace_s": seconds,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": trace.peak + scalars - arg_bytes,
                   "peak_bytes": trace.peak + scalars},
        "cost": {"flops": float(trace.flops), "bytes_accessed": float(trace.bytes_accessed)},
        "collectives": trace.stats(),
    }


def _probe_cfgs(cfg):
    """Reduced-depth unrolled variants + the scale rule (see module doc)."""
    r = dataclasses.replace
    base = dict(scan_layers=False, force_dense_attn=True)
    fam = cfg.family
    if fam in ("dense", "moe", "ssm"):
        return {
            "a": r(cfg, n_layers=1, **base),
            "b": r(cfg, n_layers=2, **base),
        }, {"layers": cfg.n_layers}
    if fam == "vlm":
        per = cfg.cross_attn_period
        return {
            "a": r(cfg, n_layers=per, **base),
            "b": r(cfg, n_layers=2 * per, **base),
        }, {"groups": cfg.n_layers // per}
    if fam == "hybrid":
        per = cfg.shared_attn_period
        groups = cfg.n_layers // per
        rem = cfg.n_layers - groups * per
        probes = {
            "a": r(cfg, n_layers=per, **base),
            "b": r(cfg, n_layers=2 * per, **base),
        }
        if rem:
            probes["c"] = r(cfg, n_layers=per + rem, **base)
        return probes, {"groups": groups, "rem": rem}
    if fam == "encdec":
        return {
            "a": r(cfg, n_layers=1, n_encoder_layers=1, **base),
            "b": r(cfg, n_layers=1, n_encoder_layers=2, **base),
            "c": r(cfg, n_layers=2, n_encoder_layers=1, **base),
        }, {"enc": cfg.n_encoder_layers, "dec": cfg.n_layers}
    raise ValueError(fam)


def _scale_costs(fam: str, probes: Dict[str, Dict], info: Dict) -> Dict:
    """Combine probe costs (flops/bytes/collective link bytes) to full depth."""

    def extract(p):
        from repro_torch.analysis.hlo import total_link_bytes

        return {
            "flops": p["cost"]["flops"],
            "bytes": p["cost"]["bytes_accessed"],
            "coll": total_link_bytes(p["collectives"]),
        }

    a = extract(probes["a"])
    b = extract(probes["b"])
    out = {}
    for key in ("flops", "bytes", "coll"):
        if fam in ("dense", "moe", "ssm"):
            per_layer = b[key] - a[key]
            out[key] = a[key] + (info["layers"] - 1) * per_layer
        elif fam == "vlm":
            per_group = b[key] - a[key]
            out[key] = a[key] + (info["groups"] - 1) * per_group
        elif fam == "hybrid":
            per_group = b[key] - a[key]
            out[key] = a[key] + (info["groups"] - 1) * per_group
            if info["rem"]:
                c = extract(probes["c"])
                out[key] += c[key] - a[key]
        elif fam == "encdec":
            c = extract(probes["c"])
            per_enc = b[key] - a[key]
            per_dec = c[key] - a[key]
            out[key] = a[key] + (info["enc"] - 1) * per_enc + (info["dec"] - 1) * per_dec
        else:
            raise ValueError(fam)
    return out


def _link_split(fam: str, runs: Dict[str, Dict], info: Dict) -> Dict:
    """The collective link bytes of `_scale_costs` split by link: {"coll_nvlink",
    "coll_network"} (for probes; a full trace as ``info`` None)."""
    out = {}
    for link in ("nvlink", "network"):
        only = {name: {"cost": {"flops": 0.0, "bytes_accessed": 0.0},
                       "collectives": {k: {"link_bytes": v[link + "_bytes"]}
                                       for k, v in run["collectives"].items()}}
                for name, run in runs.items()}
        out["coll_" + link] = (_scale_costs(fam, only, info)["coll"] if info is not None
                               else sum(v["link_bytes"] for v in only["full"]["collectives"]
                                        .values()))
    return out


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def run_cell(
    arch: str, shape_name: str, mesh_kind: str, probes: bool = True,
    overrides: Optional[Dict] = None, skip_production: bool = False, device_type: str = "cpu",
) -> Dict:
    """One cell's record (the reference's schema, with ``mesh_shape``):
    the production trace on the ``mesh_kind`` mesh; on the single pod also
    the probes and their scaled cost.  ``scaled_cost`` (what the roofline
    reads) is the probes' scaled cost where they ran, else the full trace's
    own; either way with the link bytes split by link."""
    from repro_torch.configs.base import SHAPE_BY_NAME
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = S.shape_applicable(cfg, shape)
    result: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if not ok:
        result["skipped"] = why
        return result

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type=device_type)
    result["mesh_shape"] = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    if not skip_production:
        cell = S.build_cell(cfg, shape, mesh)
        result["production"] = _trace_cell(cell, mesh)
        full = result["production"]
        result["scaled_cost"] = {"flops": full["cost"]["flops"],
                                 "bytes": full["cost"]["bytes_accessed"],
                                 "coll": sum(v["link_bytes"]
                                             for v in full["collectives"].values()),
                                 **_link_split(cfg.family, {"full": full}, None)}

    if probes and mesh_kind == "single":
        probe_cfgs, info = _probe_cfgs(cfg)
        probe_results = {}
        for name, pcfg in probe_cfgs.items():
            pcell = S.build_cell(pcfg, shape, mesh)
            probe_results[name] = _trace_cell(pcell, mesh)
        result["probes"] = probe_results
        result["scaled_cost"] = {**_scale_costs(cfg.family, probe_results, info),
                                 **_link_split(cfg.family, probe_results, info)}
        result["probe_info"] = info
    return result


def _sweep(args) -> int:
    """``--all``: one subprocess a cell (a bad cell fails alone), ``--jobs``
    at a time; a cell whose file exists is skipped."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCH_IDS

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh_kind in meshes:
                out = os.path.join(args.out_dir, f"{arch}__{shape.name}__{mesh_kind}.json")
                if os.path.exists(out):
                    print(f"[skip] {out} exists", flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape.name, "--mesh", mesh_kind, "--out", out,
                       "--device", args.device]
                if args.no_probes:
                    cmd.append("--no-probes")
                todo.append(((arch, shape.name, mesh_kind), cmd))
    failures, running = [], []
    while todo or running:
        while todo and len(running) < args.jobs:
            name, cmd = todo.pop(0)
            print(f"[run ] {' x '.join(name)}", flush=True)
            running.append((name, subprocess.Popen(cmd, stdout=subprocess.DEVNULL)))
        done = [(name, proc) for name, proc in running if proc.poll() is not None]
        if not done:
            time.sleep(1.0)
        for name, proc in done:
            running.remove((name, proc))
            if proc.returncode != 0:
                failures.append(name)
                print(f"[FAIL] {' x '.join(name)}", flush=True)
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--skip-production", action="store_true",
                    help="probes only (fast §Perf iteration)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="the fake mesh's device type (cuda needs a CUDA build of torch)")
    ap.add_argument("--jobs", type=int, default=1, help="--all: cells traced at once")
    args = ap.parse_args(argv)

    if args.all:
        sys.exit(_sweep(args))

    import warnings

    warnings.filterwarnings("ignore")
    t0 = time.perf_counter()
    try:
        overrides = dict(_parse_override(kv) for kv in args.set)
        res = run_cell(args.arch, args.shape, args.mesh,
                       probes=not args.no_probes, overrides=overrides,
                       skip_production=args.skip_production, device_type=args.device)
    except Exception:
        res = {
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "error": traceback.format_exc(),
        }
    res["wall_s"] = time.perf_counter() - t0
    blob = json.dumps(res, indent=1, default=float)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(blob)
    print(blob[:2000])
    if "error" in res:
        print(res["error"][-6000:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
