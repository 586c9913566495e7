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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch


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
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=_device(params))}


def _device(tree) -> torch.device:
    return next(leaf for _, leaf in tree_leaves(tree)).device


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-d tensor)."""
    total = None
    for _, leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: Dict, params, cfg: AdamWConfig) -> Tuple[Any, Dict, Dict]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}), the parameters
    and moments updated in place."""
    step = state["step"] + 1
    lr = cfg.lr if cfg.schedule is None else cfg.schedule(step) * cfg.lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(state["m"]))
    flat_v = dict(tree_leaves(state["v"]))
    for path, p in tree_leaves(params):
        g = flat_g[path].float() * scale
        m, v = flat_m[path], flat_v[path]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        del g
        pf = p.float()
        p.copy_((pf - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                            + cfg.weight_decay * pf)).to(p.dtype))
    state["step"] = step
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
