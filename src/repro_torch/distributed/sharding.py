"""Coadd mesh residency: which flat slab of a layout each rank holds.

Counterpart of the coadd half of ``repro.distributed.sharding``.  The
reference shards an image-major (M, ...) layout over a JAX device mesh with
``NamedSharding(mesh, P(shard_axes))`` and runs one program on every device
under ``shard_map``.  Here the mesh is a ``torch.distributed`` `DeviceMesh`
and the program is SPMD over its process group: every rank runs the same
job (`CoaddEngine.run_distributed`), and its body, the part the reference
hands to ``shard_map``, maps this rank's slab only.  So ``shard_map_compat``
has no counterpart, and `image_axis_slab` replaces `image_axis_sharding`:
it names the contiguous slab ``[s*L, (s+1)*L)`` that the sharding puts on
this rank's device.

The LM half ports the reference's sharding rules (MaxText-style 2D "FSDP +
TP"): weight matrices split their d_model-ish dimension over ``data`` and
their wide dimension over ``model``; expert stacks split d_ff over
``model`` only; a few vectors follow a model-split dimension; ``pure_dp``
turns the model axis into more FSDP.  A spec is a tuple with one entry a
dimension, each None, a mesh axis name or a tuple of axis names (what a
``PartitionSpec`` holds).  Every rule function takes a named `DeviceMesh`
or a plain ``{axis: size}`` mapping, so the specs of a production mesh can
be computed with no ranks.  `placements` turns a spec into DTensor
placements and `distribute_tree` places a parameter tree by them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import scan_budget


def mesh_shape(mesh) -> Dict[str, int]:
    """{dimension name: size} of a named `DeviceMesh` (``mesh.shape`` of a JAX
    mesh)."""
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, (int(n) for n in mesh.mesh.shape)))


def shard_count(mesh, axes: Sequence[str]) -> int:
    """Total number of shards over the given mesh axes."""
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes])) if axes else 1


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's shard over ``axes``: its mesh coordinates taken row-major
    over the named axes in their order, the order in which
    ``NamedSharding(mesh, P(tuple(axes)))`` splits axis 0 over a tuple of
    axes.  A mesh axis not among ``axes`` replicates the slab."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    s = 0
    for a in axes:
        s = s * shape[a] + int(coord[a])
    return s


def image_axis_slab(mesh, shard_axes: Sequence[str], n_flat: int) -> Tuple[int, int]:
    """[start, stop) of this rank's slab of an image-major axis of
    ``n_flat`` entries split over ``shard_axes``: the rows the reference's
    `image_axis_sharding` puts on this rank's device.  ``n_flat`` must
    divide by the shard count."""
    n = shard_count(mesh, shard_axes)
    if n_flat % n:
        raise ValueError(f"shard count {n} must divide flat length {n_flat}")
    local = n_flat // n
    s = shard_index(mesh, shard_axes)
    return s * local, (s + 1) * local


def shard_local_compaction(
    union_gate: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Per-shard gather indices for a job's union flat gate (DESIGN.md §5).

    ``union_gate`` is the (M,) OR of every query's flat slot gate; shard
    ``s`` holds the contiguous slab ``[s*L, (s+1)*L)`` with
    ``L = M // n_shards``.  Each shard maps only the slab entries some query
    selected, so this derives, per shard, the *local* indices of its gated
    slots, padded to one shared shape (`plan.scan_budget` bucket of the
    worst shard's count), and each shard's OWN bucketed budget: the executor
    picks one power-of-two tile size dividing the shared budget and maps
    ``ceil(own_budget / tile)`` tiles per shard, so quiet shards stop paying
    the busiest shard's work.

    Returns ``(local_idx (S, G) int32, pad_mask (S, G) bool, G,
    budgets (S,) int32)`` with ``G == budgets.max()``; padding entries
    point at local slot 0 and are masked False in the compacted per-query
    gates, the same duplicate-then-mask discipline as `plan.compact_gate`.
    """
    m = union_gate.shape[0]
    if m % n_shards:
        raise ValueError(
            f"shard count {n_shards} must divide flat length {m}"
        )
    local_len = m // n_shards
    per_shard = union_gate.reshape(n_shards, local_len)
    counts = per_shard.sum(axis=1)
    budgets = np.array(
        [scan_budget(int(c), local_len) for c in counts], np.int32
    )
    budget = int(budgets.max())
    local_idx = np.zeros((n_shards, budget), np.int32)
    pad_mask = np.zeros((n_shards, budget), bool)
    for s in range(n_shards):
        nz = np.nonzero(per_shard[s])[0][:budget]
        local_idx[s, : len(nz)] = nz
        pad_mask[s, : len(nz)] = True
    return local_idx, pad_mask, budget, budgets


# ---------------------------------------------------------------- params ---

#: A spec: one entry a tensor dimension, each None, an axis or a tuple of axes.
Spec = Tuple[Any, ...]

# name -> spec template for the *trailing* dims; leading (stacked-layer /
# group) dims get None.  Tied tables keep vocab-sharding ("embedding_tied")
# so the unembed contraction stays collective-free.
_MATRIX_RULES = {
    "embedding": (None, "model"),
    "embedding_tied": ("model", None),
    "unembed": ("model", None),
    "w_q": ("data", "model"),
    "w_k": ("data", "model"),
    "w_v": ("data", "model"),
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_o": ("model", "data"),
    "w_down": ("model", "data"),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "router": (None, None),
    "conv_w": (None, "model"),
}
# 3D expert stacks (E, ., .): replicated over ``data``, TP over d_ff only.
_EXPERT_RULES = {
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),
}
_VECTOR_RULES = {
    "b_q": ("model",),
    "b_k": ("model",),
    "b_v": ("model",),
    "conv_b": ("model",),
}
#: Path keys that name a sub-module, not a parameter.
_MODULE_KEYS = ("moe", "mamba", "attn", "cross", "mlp")


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a named `DeviceMesh`, or of a mapping as it is."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return mesh_shape(mesh)


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of a spec entry (None, a name or a tuple of names)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes):
    """A spec entry as a ``PartitionSpec`` holds it: None for no axes, the
    name for one, the tuple for several."""
    axes = axes_of(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _fit_to_shape(spec_axes, shape, mesh) -> Spec:
    """Drop axis assignments whose dim isn't divisible by the mesh axes: a
    non-divisible dim (12 q heads on a 16-way model axis, vocab 51866, 40
    experts) is replicated instead, never split unevenly."""
    sizes = axis_sizes(mesh)
    fitted = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            fitted.append(None)
            continue
        size = int(np.prod([sizes[a] for a in axes_of(ax)]))
        fitted.append(ax if dim % size == 0 else None)
    return tuple(fitted)


def _spec_for(path: Tuple[str, ...], shape, mesh) -> Spec:
    name = next((k for k in reversed(path) if k not in _MODULE_KEYS), None)
    shape = tuple(shape)
    ndim = len(shape)
    if name in _MATRIX_RULES:
        base = (_EXPERT_RULES[name] if "moe" in path and name in _EXPERT_RULES
                else _MATRIX_RULES[name])
        pad = ndim - len(base)
        if pad < 0:
            return ()
        return _fit_to_shape([None] * pad + list(base), shape, mesh)
    if name in _VECTOR_RULES:
        base = _VECTOR_RULES[name]
        return _fit_to_shape([None] * (ndim - len(base)) + list(base), shape, mesh)
    # scales, A_log, D, dt_bias, biases without rules: replicated.
    return (None,) * ndim


def _substitute_pure_dp(base) -> list:
    """pure_dp: the model axis becomes more FSDP: "data" -> ("data", "model"),
    "model" -> None (no tensor parallelism)."""
    return [("data", "model") if ax == "data" else None if ax == "model" else ax
            for ax in base]


def _walk(tree, fn, path=()):
    if isinstance(tree, Mapping):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params_shape, mesh, pure_dp: bool = False):
    """Tree of specs matching a parameter (or moment) tree of tensors or
    shapes (anything with ``.shape``)."""
    tied = (isinstance(params_shape, Mapping) and "embed" in params_shape
            and "unembed" not in params_shape.get("embed", {}))

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if path[-1] == "embedding" and tied:
            s = _fit_to_shape(list(_MATRIX_RULES["embedding_tied"]), shape, mesh)
        else:
            s = _spec_for(path, shape, mesh)
        if pure_dp:
            s = _fit_to_shape(_substitute_pure_dp(s), shape, mesh)
        return s

    return _walk(params_shape, spec)


def strip_axis(tree_specs, axis: str = "data"):
    """Remove one mesh axis from every spec (zero1: the compute copy keeps
    only the model-axis TP; ``data`` holds the float32 masters and moments)."""

    def strip(spec):
        out = []
        for entry in spec:
            if entry == axis:
                out.append(None)
            elif isinstance(entry, tuple):
                out.append(_entry(a for a in entry if a != axis))
            else:
                out.append(entry)
        return tuple(out)

    return _walk(tree_specs, lambda _, s: strip(s))


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements, one a mesh dimension, that split a tensor as
    ``NamedSharding(mesh, spec)`` does.

    A tuple entry splits its dimension row-major over its axes in the
    tuple's order; DTensor splits a dimension over several mesh dimensions
    in mesh order, so a tuple whose order differs from the mesh's raises.
    A mesh dimension used twice raises too.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    used = set()
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} splits dim {dim} in another order than "
                             f"the mesh's axes {names}")
        for i, a in zip(idx, axes):
            if a in used:
                raise ValueError(f"mesh axis {a!r} used twice in spec {spec!r}")
            used.add(a)
            out[i] = Shard(dim)
    return out


def named_shardings(tree_specs, mesh):
    """Tree of DTensor placements (`placements`) of a tree of specs."""
    return _walk(tree_specs, lambda _, s: placements(s, mesh))


def redistribute(tensor, spec: Spec):
    """A DTensor redistributed to ``spec`` (fitted to its shape); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tensor, DTensor):
        return tensor
    mesh = tensor.device_mesh
    return tensor.redistribute(mesh, placements(_fit_to_shape(spec, tensor.shape, mesh), mesh))


class _Gathered(torch.autograd.Function):
    """A DTensor redistributed for one use, its gradient redistributed back
    to the source placements at once in the backward (a partial sum is
    reduced there, one layer at a time, rather than kept at full size)."""

    @staticmethod
    def forward(ctx, tensor, placements):
        ctx.source = tensor.placements
        return tensor.redistribute(tensor.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.source), None


def gathered(tensor, spec: Spec):
    """A DTensor placed by ``spec`` for one use (`_Gathered`: its gradient
    goes back to the tensor's own placements in the backward); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tensor, DTensor):
        return tensor
    return _Gathered.apply(tensor, tuple(placements(spec, tensor.device_mesh)))


def reduced(tensor):
    """A DTensor with its partial sums reduced (those mesh dimensions
    replicated); anything else as it is.  Before a bias is added: DTensor's
    rule for a partial sum plus a split bias may ask for a redistribution
    it does not have (on the card's torch, 2.11: Shard to Partial)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(tensor, DTensor) or not any(p.is_partial() for p in tensor.placements):
        return tensor
    return tensor.redistribute(tensor.device_mesh, [Replicate() if p.is_partial() else p
                                                    for p in tensor.placements])


def pin_grad(tensor):
    """``tensor`` as it is, its gradient redistributed to its placements in
    the backward (where a view's backward would meet a split it cannot
    take); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tensor, DTensor):
        return tensor
    return _Gathered.apply(tensor, tuple(tensor.placements))


def replicate_dim(tensor, dim: int):
    """A DTensor with dimension ``dim`` gathered on every rank (each mesh
    dimension that splits it replicates instead, the others kept); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(tensor, DTensor):
        return tensor
    dim %= tensor.ndim
    pl = [Replicate() if p.is_shard() and p.dim % tensor.ndim == dim else p
          for p in tensor.placements]
    return tensor.redistribute(tensor.device_mesh, pl)


def split_last(tensor, parts: int):
    """``tensor`` (..., parts * d) viewed as (..., parts, d).  A DTensor whose
    last dimension is split over more shards than divide ``parts`` (12
    heads over a 16-way model axis) has that dimension gathered first: a
    shard may not end inside a part."""
    from torch.distributed.tensor import DTensor

    if isinstance(tensor, DTensor):
        n = math.prod(tensor.device_mesh.size(i) for i, p in enumerate(tensor.placements)
                      if p.is_shard() and p.dim % tensor.ndim == tensor.ndim - 1)
        if parts % n:
            tensor = replicate_dim(tensor, -1)
    return tensor.reshape(*tensor.shape[:-1], parts, tensor.shape[-1] // parts)


def match(tensor, like):
    """A DTensor redistributed to the placements of ``like`` (a DTensor of
    the same mesh); anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(tensor, DTensor) and isinstance(like, DTensor)):
        return tensor
    return tensor.redistribute(like.device_mesh, like.placements)


def local_spec(mesh, batch_axes: Sequence[str], batch: int, ndim: int,
               head_dim: int = None, heads: Sequence[int] = ()) -> Spec:
    """The spec of an operand of ``ndim`` dims that a kernel runs on local
    shards: dim 0 (``batch`` rows) over ``batch_axes`` when they divide it,
    and dim ``head_dim`` over ``model`` when ``model`` is not a batch axis
    and divides every head count of ``heads`` (attention's q and kv heads
    together)."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in batch_axes if a in sizes)
    spec = [None] * ndim
    if axes and batch % int(np.prod([sizes[a] for a in axes])) == 0:
        spec[0] = axes
    if (head_dim is not None and "model" in sizes and "model" not in (spec[0] or ())
            and all(n % sizes["model"] == 0 for n in heads)):
        spec[head_dim] = "model"
    return tuple(spec)


def on_shards(fn, mesh, in_placements, out_placements, in_grad_placements=None):
    """``fn`` as a function of DTensors that runs on each rank's local
    shards (``local_map``): each DTensor argument redistributed to its
    entry of ``in_placements`` first (None: not a tensor), the outputs
    placed by ``out_placements``, the arguments' gradients by
    ``in_grad_placements`` (by default as the inputs)."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def row_grads(spec: Spec, mesh) -> list:
    """The placements of a whole tensor's gradient when each rank computes
    it from the rows ``spec`` gives it: a partial sum over the axes that
    split dim 0."""
    return partial_over((), mesh, axes_of(spec[0]))


def partial_over(spec: Spec, mesh, axes: Sequence[str]) -> list:
    """``spec``'s placements with every mesh dimension of ``axes`` a partial
    sum instead: the placements of a gradient each rank holds a part of."""
    from torch.distributed.tensor import Partial

    names = tuple(mesh.mesh_dim_names)
    pl = placements(spec, mesh)
    for a in axes:
        pl[names.index(a)] = Partial()
    return pl


def local_part(tensor, spec: Spec, mesh):
    """This rank's slice (a view) of the full ``tensor`` under ``spec``: along
    each split dimension the block at this rank's row-major index over the
    entry's axes, as ``NamedSharding(mesh, spec)`` assigns it."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out = tensor
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for a in axes_of(entry):
            idx = idx * sizes[a] + int(coord[a])
            n *= sizes[a]
        if n == 1:
            continue
        if tensor.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not divide over {entry!r}")
        size = tensor.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def distribute(tensor, spec: Spec, mesh):
    """``tensor`` (the same full value on every rank) as a DTensor placed by
    ``spec``: each rank keeps a copy of its own slice (`local_part`), no
    collective."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, mesh)
    local = local_part(tensor, spec, mesh).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def distribute_tree(tree, tree_specs, mesh):
    """`distribute` every leaf of a tree by the matching spec."""
    return _walk(tree, lambda path, t: distribute(t, _get(tree_specs, path), mesh))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ----------------------------------------------------------- activations ---

def dp_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _dp_if_divisible(mesh, size: int, pure_dp: bool = False):
    sizes = axis_sizes(mesh)
    axes = dp_axes(sizes)
    if pure_dp and "model" in sizes:
        axes = axes + ("model",)
    while axes:
        total = int(np.prod([sizes[a] for a in axes]))
        if size % total == 0:
            return axes
        axes = axes[1:] if len(axes) > 1 else ()
    if "data" in sizes and size % sizes["data"] == 0:
        return ("data",)
    return None


def batch_pspec(mesh, global_batch: int, extra_dims: int = 1, pure_dp: bool = False) -> Spec:
    """(B, S[, ...]): batch over (pod, data) when divisible, rest replicated."""
    return (_entry(_dp_if_divisible(mesh, global_batch, pure_dp)),) + (None,) * extra_dims


def cache_pspec(mesh, batch: int, leaf_shape, seq_axis: int) -> Spec:
    """Stacked KV cache (L, B, T, H, Dh): B over the data axes, T over model."""
    sizes = axis_sizes(mesh)
    spec = [None] * len(leaf_shape)
    spec[1] = _entry(_dp_if_divisible(sizes, batch))
    if "model" in sizes and leaf_shape[seq_axis] % sizes["model"] == 0:
        spec[seq_axis] = "model"
    return tuple(spec)


# ------------------------------------------------------------ collectives ---

#: The dispatch keys whose functional all-gather `route_all_gather` replaced
#: (the registrations live as long as the process).
_ROUTED: Dict[str, Any] = {}


def _eager_all_gather(tensor, group_size: int, group_name):
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = group_name if isinstance(group_name, dist.ProcessGroup) else \
        _resolve_process_group(group_name)
    x = tensor.contiguous()
    out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def route_all_gather(device_type: str) -> None:
    """Carry DTensor's all-gathers of ``device_type`` tensors through the
    eager ``all_gather_into_tensor``.

    DTensor gathers through the functional collective
    ``_c10d_functional.all_gather_into_tensor``; on a gloo group over CUDA
    tensors (ranks sharing one card) that op crashes the process in the
    torch of the card's machine (2.11), while the eager collective of the
    same group, and the functional all-reduce, reduce-scatter and
    all-to-all, work.  This registers the eager form as the op's kernel for
    ``device_type``'s dispatch key, for the rest of the process.
    """
    import torch

    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    if key in _ROUTED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _eager_all_gather, key)
    _ROUTED[key] = lib


def carry_collectives(mesh) -> None:
    """Make DTensor's collectives on ``mesh`` ones its group carries: a gloo
    group over CUDA tensors gathers through `route_all_gather`."""
    import torch.distributed as dist

    if mesh.device_type == "cuda" and dist.get_backend(mesh.get_group(0)) == "gloo":
        route_all_gather("cuda")


# ------------------------------------------------------------ the cache ---

def cache_pspecs(cache_shape, mesh, batch: int):
    """Tree of specs of a stacked serving cache (the rule of the JAX
    package's ``launch/specs.py::cache_shardings``): KV leaves (L, B, T, H,
    Dh) split T over ``model`` and B over the data axes (`cache_pspec`: a
    distributed KV cache, flash-decode style); a conv state (L, B, W-1, C)
    its channels and an SSM state (L, B, H, N, P) its heads over ``model``
    where they divide; B over the data axes where it divides."""
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1)

    def spec(path, leaf):
        name, shape = path[-1], tuple(leaf.shape)
        nd = len(shape)
        if name in ("k", "v", "cross_k", "cross_v") and nd == 5:
            return cache_pspec(sizes, batch, shape, seq_axis=2)
        b_axes = _entry(_dp_if_divisible(sizes, batch))
        if name == "conv" and nd == 4:
            return (None, b_axes, None, "model" if shape[3] % msize == 0 else None)
        if name == "ssm" and nd == 5:
            return (None, b_axes, "model" if shape[2] % msize == 0 else None, None, None)
        return tuple(b_axes if d == 1 else None for d in range(nd))

    return _walk(cache_shape, spec)


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The local shape of a tensor of ``shape`` placed by ``spec`` (each split
    dimension divides: `_fit_to_shape`)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= int(np.prod([sizes[a] for a in axes_of(entry)]))
    return tuple(out)


def zeros(shape, spec: Spec, mesh, dtype, device):
    """A DTensor of zeros of global ``shape`` placed by ``spec``, made from
    each rank's zero shard (the global tensor never exists)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    local = torch.zeros(shard_shape(shape, spec, mesh), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def like_local(local, like):
    """A DTensor of ``like``'s mesh, placements, shape and strides whose
    shard on this rank is ``local``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def layer(leaf, i: int):
    """Layer ``i`` of a stacked leaf: ``leaf[i]``, for a DTensor (its layer
    dimension whole) a DTensor whose shard is a view of the leaf's shard, so
    that a write into it is a write into the leaf."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(leaf, DTensor):
        return leaf[i]
    if any(p.is_shard(0) for p in leaf.placements):
        raise ValueError("a stacked leaf split over its layers has no local layer")
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in leaf.placements]
    return DTensor.from_local(leaf.to_local()[i], leaf.device_mesh, pl, run_check=False,
                              shape=leaf.shape[1:], stride=leaf.stride()[1:])


def slab(tensor, dim: int) -> Tuple[int, int]:
    """[start, stop) of this rank's shard of a DTensor along ``dim`` (split
    row-major over the mesh dimensions that split it, in mesh order)."""
    mesh = tensor.device_mesh
    coord = mesh.get_coordinate()
    dim %= tensor.ndim
    n, idx = 1, 0
    for i, p in enumerate(tensor.placements):
        if p.is_shard(dim):
            idx = idx * mesh.size(i) + int(coord[i])
            n *= mesh.size(i)
    size = tensor.shape[dim] // n
    return idx * size, (idx + 1) * size


def split_group(tensor, dim: int):
    """The process group of the ranks that hold the other shards of a
    DTensor's dimension ``dim`` (None when it is whole); one mesh dimension
    at most may split it."""
    dim %= tensor.ndim
    mesh = tensor.device_mesh
    split = [i for i, p in enumerate(tensor.placements) if p.is_shard(dim) and mesh.size(i) > 1]
    if not split:
        return None
    if len(split) > 1:
        raise ValueError(f"dim {dim} is split over mesh dims {split}: one at most")
    return mesh.get_group(split[0])


def all_reduce(tensor, op: str, group):
    """``tensor`` reduced (``"sum"``, ``"max"``) over ``group`` (a
    functional collective, waited on)."""
    out = torch.ops._c10d_functional.all_reduce(tensor.contiguous(), op, group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


def all_gather_dim(tensor, dim: int, group):
    """The shards of ``group``'s ranks concatenated along ``dim``, in rank
    order (a functional collective, waited on)."""
    n = group.size()
    out = torch.ops._c10d_functional.all_gather_into_tensor(tensor.contiguous(), n,
                                                            group.group_name)
    out = torch.ops._c10d_functional.wait_tensor(out)
    return out if dim % tensor.ndim == 0 else torch.cat(out.chunk(n, 0), dim)


def write_layer(leaf, i: int, value, dim=None, start: int = 0) -> None:
    """`write_slab` into layer ``i`` of a stacked leaf (`layer`)."""
    write_slab(layer(leaf, i), value, dim, start)


def write_slab(dst, value, dim=None, start: int = 0) -> None:
    """``dst`` = ``value`` in place, or with ``dim`` its positions [start,
    start + value.shape[dim]) along ``dim``.  A DTensor ``dst`` is written
    on each rank's shard: ``value`` is redistributed to ``dst``'s
    placements, ``dim`` whole, and each rank writes the part that falls in
    its slab of ``dim`` (a KV cache split over T: a decode step's token goes
    to the one rank that holds its position, no collective)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(dst, DTensor):
        (dst if dim is None else dst.narrow(dim, start, value.shape[dim])).copy_(value)
        return
    pl = list(dst.placements)
    if dim is not None:
        dim %= dst.ndim
        pl = [Replicate() if p.is_shard(dim) else p for p in pl]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, dst.device_mesh, [Replicate()] * len(pl),
                                   run_check=False)
    local, out = value.redistribute(dst.device_mesh, pl).to_local(), dst.to_local()
    if dim is None:
        out.copy_(local)
        return
    lo, hi = slab(dst, dim)
    a, b = max(lo, start), min(hi, start + value.shape[dim])
    if a < b:
        out.narrow(dim, a - lo, b - a).copy_(local.narrow(dim, a - start, b - a))
