"""Step builders: the train, prefill and decode steps of an `LM`.

A port of the step builders of the JAX package's ``launch/specs.py``.  The
rest of that module (input specs, shardings, ``build_cell``) belongs to the
dry run and waits for it (ROADMAP queue 1 item 5c).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves, tree_map


def make_train_step(model: LM, ocfg: Optional[AdamWConfig] = None,
                    compute_pspecs=None) -> Callable:
    """Train step ``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``loss.backward()`` on the float32 masters (the model casts to its
    compute dtype at use), then `adamw_update` under ``torch.no_grad``,
    which updates the parameters and moments in place.  ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device: the
    step reads nothing back to the host.  The parameters' ``.grad`` are
    cleared again before it returns.
    """
    if compute_pspecs is not None:
        raise NotImplementedError("the zero1 compute copy waits for the LM sharding slice "
                                  "(ROADMAP queue 1 item 5b)")
    ocfg = ocfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            loss = model.loss(params, batch)
            loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, ocfg)
        for p in leaves:
            p.grad = None
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: LM, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: LM) -> Callable:
    def decode_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return decode_step
