"""AdamW over a parameter dict: global-norm clip, decoupled weight decay.

A port of the JAX package's ``optim/adamw.py``.  The optimizer state is a
dict shaped like the parameters, ``{"m": ..., "v": ..., "step"}``, with
``step`` a 0-d int32 tensor on the parameters' device.  The math is float32
and each parameter is cast back to its own dtype.  Nothing in the update
reads a value back to the host: the clip factor, the bias corrections and
a scheduled learning rate are all tensors on the device.

Unlike the JAX package, which returns new trees, `adamw_update` writes
the new moments and parameters into the tensors it is given (under
``torch.no_grad``) and returns those same dicts: at qwen2-1.5b a second set
of float32 parameters and moments would cost 18.5 GB of device memory.

Parameters placed on a device mesh (DTensors, `repro_torch.launch.specs.
ShardedTrainStep`) are updated the same way on each rank's local shard:
every gradient and moment must share its parameter's placements, and
`global_norm` sums the shards once each (a replicated copy counted once)
into a replicated scalar, the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, keys sorted at every level (the order
    of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def adamw_init(params) -> Dict:
    """Zero moments shaped (and placed) as the parameters; ``step`` 0, on a
    mesh replicated."""
    first = next(leaf for _, leaf in tree_leaves(params))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    mesh = _mesh(first)
    if mesh is not None:
        from torch.distributed.tensor import Replicate, distribute_tensor

        step = distribute_tensor(step, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
            "step": step}


def _mesh(x):
    """The device mesh of a DTensor, None for a plain tensor."""
    return x.device_mesh if isinstance(x, DTensor) else None


def _local(x):
    """A DTensor's local shard (its storage, under no_grad), a plain tensor as is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _owner(leaf) -> bool:
    """Whether this rank's shard of ``leaf`` counts in a sum over every rank:
    on each mesh dimension that replicates it, only coordinate 0 counts."""
    from torch.distributed.tensor import Replicate, Shard

    coord = leaf.device_mesh.get_coordinate()
    for i, p in enumerate(leaf.placements):
        if isinstance(p, Replicate) and coord[i] != 0:
            return False
        if not isinstance(p, (Replicate, Shard)):
            raise ValueError(f"a norm needs sharded or replicated leaves, got {leaf.placements}")
    return True


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor).

    For DTensor leaves (one mesh): each rank sums the squares of the shards
    it owns (`_owner`), one partial sum a rank, reduced over the mesh into a
    replicated 0-d DTensor."""
    leaves = [leaf for _, leaf in tree_leaves(tree)]
    mesh = _mesh(leaves[0])
    total = None
    for leaf in leaves:
        if mesh is not None:
            if leaf.device_mesh != mesh:
                raise ValueError("every leaf of a norm must lie on one mesh")
            local = leaf.to_local()
            sq = torch.sum(torch.square(local.float())) if _owner(leaf) else \
                local.new_zeros((), dtype=torch.float32)
        else:
            sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    if mesh is None:
        return torch.sqrt(total)
    from torch.distributed.tensor import Partial, Replicate

    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(total.redistribute(mesh, [Replicate()] * mesh.ndim))


def _check_placed(path, g, p, *moments):
    """A DTensor gradient and moments must share the parameter's mesh and placements."""
    for name, x in (("gradient", g),) + tuple(zip(("m", "v"), moments)):
        if _mesh(x) != _mesh(p) or (_mesh(p) is not None and x.placements != p.placements):
            raise ValueError(f"{path}: {name} placed {getattr(x, 'placements', None)}, its "
                             f"parameter {getattr(p, 'placements', None)}")


@torch.no_grad()
def adamw_update(grads, state: Dict, params, cfg: AdamWConfig) -> Tuple[Any, Dict, Dict]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}), the parameters
    and moments updated in place."""
    step = state["step"] + 1
    step_l = _local(step)
    lr = cfg.lr if cfg.schedule is None else cfg.schedule(step_l) * cfg.lr
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(state["m"]))
    flat_v = dict(tree_leaves(state["v"]))
    for path, p in tree_leaves(params):
        _check_placed(path, flat_g[path], p, flat_m[path], flat_v[path])
    gnorm = _local(global_norm(grads))
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step_l.float()
    b2c = 1.0 - cfg.b2 ** step_l.float()
    for path, p in tree_leaves(params):
        g = _local(flat_g[path]).float() * scale
        m, v, p = _local(flat_m[path]), _local(flat_v[path]), _local(p)
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        del g
        pf = p.float()
        p.copy_((pf - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                            + cfg.weight_decay * pf)).to(p.dtype))
    state["step"] = step
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=step_l.device)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
