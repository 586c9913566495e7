"""int8 gradient compression with error feedback (1-bit-Adam-style family).

A port of the JAX package's ``optim/compression.py``: each leaf plus its
carried error is scaled by its max |value| / 127, rounded half to even
(``torch.round``, as ``jnp.round``) and clipped to int8; the residual is
carried into the next step (Seide et al. 2014; Karimireddy et al. 2019).
Trees are dicts; the leaves keep their paths.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import tree_map


def compress_leaf(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                               torch.Tensor]:
    """Returns (q int8, scale float32 0-d, new_err)."""
    combined = g.float() + err
    scale = torch.clamp_min(combined.abs().max() / 127.0, 1e-12)
    q = torch.clamp(torch.round(combined / scale), -127, 127).to(torch.int8)
    new_err = combined - q.float() * scale
    return q, scale, new_err


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_tree(grads, err_state):
    """Tree-wise compression. Returns (q_tree, scale_tree, new_err_state)."""
    out = tree_map(compress_leaf, grads, err_state)
    return _part(out, 0), _part(out, 1), _part(out, 2)


def _part(tree, i):
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    return tree[i]


def decompress_tree(q_tree, scale_tree):
    return tree_map(decompress_leaf, q_tree, scale_tree)


def compressed_gradients(grads, err_state):
    """compress -> (simulated wire) -> decompress, threading error feedback."""
    q, s, new_err = compress_tree(grads, err_state)
    return decompress_tree(q, s), new_err
