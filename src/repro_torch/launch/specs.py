"""The train, prefill and decode steps of an `LM`, and the train step
sharded on a device mesh.

A port of the step functions of the JAX package's ``launch/specs.py``, with
its zero1 compute copy (``compute_pspecs``), the act-axes rule of its
``build_cell`` (`act_axes`) and the placements ``build_cell`` gives a
train step's inputs and outputs (`ShardedTrainStep`).  The rest of that
module (input specs, batch and cache shardings, ``build_cell``) belongs to
the dry run and waits for it (ROADMAP queue 1 item 2).

On a mesh the parameters, moments and batch are DTensors placed by
`repro_torch.distributed.sharding`; the model's plain torch runs on them
through DTensor's sharding propagation (plain tensors it makes, such as
positions and masks, count as replicated), and the hand-written kernels
run on each rank's local shards (their wrappers' ``local_map``).  The
backward leaves many gradients as partial sums: the step redistributes
every gradient to its parameter's placements before `adamw_update`, the
reduce-scatter GSPMD inserts for the reference's ``out_shardings``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shard_rules
from repro_torch.models.model import LM, build_model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, tree_leaves,
                                     tree_map)


def _replicating(params):
    """DTensor's implicit replication of plain tensors while a step runs on
    DTensor parameters; nothing for plain ones."""
    if isinstance(next(leaf for _, leaf in tree_leaves(params)), DTensor):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _compute_copy(master, spec):
    """zero1: a float32 master as a bf16 leaf (another dtype as it is), on a
    mesh redistributed to ``spec`` (one all-gather over the stripped axis)."""
    c = master.detach()
    if c.dtype == torch.float32:
        c = c.to(torch.bfloat16)
    if isinstance(c, DTensor):
        c = shard_rules.redistribute(c, spec)
    return c.requires_grad_(True)


def _to_params(grad, param):
    """A gradient in its parameter's dtype and, on a mesh, placements."""
    if isinstance(param, DTensor):
        grad = grad.redistribute(param.device_mesh, param.placements)
    return grad.to(param.dtype)


def _value(x):
    """A replicated DTensor's value on this rank, a plain tensor as is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(model: LM, ocfg: Optional[AdamWConfig] = None,
                    compute_pspecs=None) -> Callable:
    """Train step ``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``loss.backward()`` on the float32 masters (the model casts to its
    compute dtype at use), then `adamw_update` under ``torch.no_grad``,
    which updates the parameters and moments in place.  ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device (on a
    mesh, each rank's copy of the replicated value): the step reads nothing
    back to the host.  The parameters' ``.grad`` are cleared again before
    it returns.

    With ``compute_pspecs`` (zero1) the loss runs on a bf16 copy of every
    float32 master, on a mesh placed by those specs (the masters' with the
    data axis stripped: one all-gather a step), and each master's gradient
    is the copy's, reduce-scattered back to the master's placements and cast
    to float32.  The parameters may be DTensors (`ShardedTrainStep`): every
    gradient then reaches `adamw_update` in its parameter's placements.
    """
    ocfg = ocfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            p.grad = None
        if compute_pspecs is None:
            for p in leaves:
                p.requires_grad_(True)
            compute = params
        else:
            compute = tree_map(_compute_copy, params, compute_pspecs)
        with torch.enable_grad(), _replicating(params):
            loss = model.loss(compute, batch)
            loss.backward()
        grads = tree_map(lambda c, p: _to_params(c.grad, p), compute, params)
        del compute
        params, opt_state, metrics = adamw_update(grads, opt_state, params, ocfg)
        for p in leaves:
            p.grad = None
        metrics["loss"] = _value(loss.detach())
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


# ------------------------------------------------------------- on a mesh ---

def act_axes(cfg: ModelConfig, mesh, global_batch: int) -> Tuple[str, ...]:
    """The activations' batch axes of a train step (the JAX package's
    ``build_cell``): the mesh's data axes; ``pure_dp`` adds ``model``; the
    ``shard_map`` MoE adds ``model`` when the global batch divides, so that
    the routed FFN runs data-parallel over every axis."""
    sizes = shard_rules.axis_sizes(mesh)
    axes = shard_rules.dp_axes(sizes)
    if cfg.pure_dp and "model" in sizes:
        axes = axes + ("model",)
    elif cfg.moe_impl == "shard_map" and "model" in sizes:
        total = int(np.prod([sizes[a] for a in axes + ("model",)]))
        if global_batch % total == 0:
            axes = axes + ("model",)
    return axes


@dataclasses.dataclass
class ShardedTrainStep:
    """`make_train_step` on a named `DeviceMesh`: the placements of its
    inputs and outputs (the JAX package's ``in_shardings`` and
    ``out_shardings``) and the step.

    ``pspecs`` place the parameters and both moments (`sharding.
    param_pspecs`, ``pure_dp`` as the config says), ``step`` is replicated,
    ``batch_spec`` places every batch leaf's first dim (`sharding.
    batch_pspec`).  `place` distributes full trees (the same on every rank)
    by them; the step returns the parameters and state in the same
    placements, updated in place.
    """

    model: LM
    mesh: object
    pspecs: Dict
    batch_spec: tuple
    step: Callable

    def place(self, params, batch):
        """(params, opt_state, batch) as DTensors: each rank keeps its slice
        of the full trees it is given (no collective); the state starts from
        `adamw_init`."""
        params = shard_rules.distribute_tree(params, self.pspecs, self.mesh)
        batch = {k: shard_rules.distribute(
            v, self.batch_spec + (None,) * (v.ndim - len(self.batch_spec)), self.mesh)
            for k, v in batch.items()}
        return params, adamw_init(params), batch

    def __call__(self, params, opt_state, batch):
        return self.step(params, opt_state, batch)


def make_sharded_train_step(cfg: ModelConfig, mesh, global_batch: int,
                            ocfg: Optional[AdamWConfig] = None,
                            device=None) -> ShardedTrainStep:
    """The train step of ``cfg`` on ``mesh`` for a global batch of
    ``global_batch`` rows: the model built with `act_axes` as its
    ``act_shard_axes``, zero1 (``cfg.param_mode``) with the data axis
    stripped from the compute copy's specs."""
    cfg = dataclasses.replace(cfg, act_shard_axes=act_axes(cfg, mesh, global_batch))
    shard_rules.carry_collectives(mesh)
    model = build_model(cfg, device=device or mesh.device_type)
    shapes = model.init_shapes()
    pspecs = shard_rules.param_pspecs(shapes, mesh, pure_dp=cfg.pure_dp)
    compute = shard_rules.strip_axis(pspecs, "data") if cfg.param_mode == "zero1" else None
    return ShardedTrainStep(
        model=model, mesh=mesh, pspecs=pspecs,
        batch_spec=shard_rules.batch_pspec(mesh, global_batch, extra_dims=0,
                                           pure_dp=cfg.pure_dp),
        step=make_train_step(model, ocfg, compute_pspecs=compute))
