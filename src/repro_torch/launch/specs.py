"""Step builders and input specs for every (arch x shape), plain and on a
device mesh.

A port of the JAX package's ``launch/specs.py``: the train, prefill and
decode steps (with the zero1 compute copy, ``compute_pspecs``), the input
stand-ins (`sds`, `batch_specs`: tensors on the ``meta`` device, no
memory), the specs of a batch and of a serving cache (`batch_shardings`,
`cache_shardings`), `CellSpec` and `build_cell`, which the dry run traces
(``launch/dryrun.py``), and `shape_applicable`.  Where the reference's
shardings are ``NamedSharding`` trees, the port's are spec tuples
(`repro_torch.distributed.sharding`), which ``sharding.placements`` turns
into DTensor placements on a named `DeviceMesh`.

On a mesh the parameters, moments, batch and cache are DTensors; the
model's plain torch runs on them through DTensor's sharding propagation
(plain tensors it makes, such as positions and masks, count as
replicated), and the hand-written kernels run on each rank's local shards
(their wrappers' ``local_map``).  The train step's backward leaves many
gradients as partial sums: it redistributes every gradient to its
parameter's placements before `adamw_update`, the reduce-scatter GSPMD
inserts for the reference's ``out_shardings``.  `make_sharded_train_step`,
`make_sharded_prefill_step` and `make_sharded_decode_step` build the three
steps of a config on a mesh with the placements `build_cell` gives them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
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
        with _replicating(params):
            return model.prefill(params, batch, max_len)

    return prefill_step


def make_decode_step(model: LM) -> Callable:
    def decode_step(params, cache, token, pos):
        with _replicating(params):
            return model.decode_step(params, cache, token, int(pos))

    return decode_step


# ------------------------------------------------------- inputs and specs ---

def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (``jax.ShapeDtypeStruct``): a tensor on the
    ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": sds((b, s), torch.int32),
        "labels": sds((b, s), torch.int32),
    }
    if cfg.family == "encdec":
        batch["enc_frames"] = sds((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = sds((b, cfg.n_image_tokens, cfg.d_model), torch.float32)
    if shape.kind == "prefill":
        batch.pop("labels")
    return batch


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, tuple]:
    bspec2 = shard_rules.batch_pspec(mesh, shape.global_batch, extra_dims=1,
                                     pure_dp=cfg.pure_dp)
    bspec3 = shard_rules.batch_pspec(mesh, shape.global_batch, extra_dims=2,
                                     pure_dp=cfg.pure_dp)
    out = {k: bspec2 for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["enc_frames"] = bspec3
    if cfg.family == "vlm":
        out["img_embeds"] = bspec3
    if shape.kind == "prefill":
        out.pop("labels")
    return out


def cache_shardings(cache_shape, mesh, batch: int):
    """Per-leaf specs of a stacked cache tree (`sharding.cache_pspecs`): KV
    leaves (L,B,T,H,Dh) split T over model (a distributed KV cache) and B
    over the data axes; SSM state leaves their channels or heads over
    model."""
    return shard_rules.cache_pspecs(cache_shape, mesh, batch)


@dataclasses.dataclass
class CellSpec:
    """Everything needed to trace one (arch x shape x mesh) cell: the step,
    its arguments as `sds` stand-ins (a Python int stays as it is), their
    specs and the outputs' (None: as the step leaves them)."""

    fn: Callable
    args: Tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: Tuple[int, ...]


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               ocfg: Optional[AdamWConfig] = None) -> CellSpec:
    """The cell of ``cfg`` at ``shape`` on ``mesh`` (a named `DeviceMesh`, or
    an ``{axis: size}`` mapping for the specs alone), as the JAX package's
    ``build_cell``: the activations' batch axes by `act_axes`, the
    parameters by ``param_pspecs`` (zero1's compute copy with the data axis
    stripped), the batch by `batch_shardings`, a decode cell's cache by
    `cache_shardings`.  The model is built on the mesh's device type (the
    CPU for a mapping)."""
    sizes = shard_rules.axis_sizes(mesh)
    cfg = dataclasses.replace(cfg, act_shard_axes=act_axes(cfg, sizes, shape.global_batch))
    model = build_model(cfg, device="cpu" if isinstance(mesh, Mapping) else mesh.device_type)
    params_shape = model.init_shapes()
    pspecs = shard_rules.param_pspecs(params_shape, sizes, pure_dp=cfg.pure_dp)
    batch = batch_specs(cfg, shape)
    bshard = batch_shardings(cfg, shape, sizes)

    if shape.kind == "train":
        compute_pspecs = (shard_rules.strip_axis(pspecs, "data")
                          if cfg.param_mode == "zero1" else None)
        step = make_train_step(model, ocfg, compute_pspecs=compute_pspecs)
        opt_shape = {"m": params_shape, "v": params_shape, "step": sds((), torch.int32)}
        oshard = {"m": pspecs, "v": pspecs, "step": ()}
        return CellSpec(fn=step, args=(params_shape, opt_shape, batch),
                        in_shardings=(pspecs, oshard, bshard),
                        out_shardings=(pspecs, oshard, None), donate_argnums=(0, 1))

    if shape.kind == "prefill":
        return CellSpec(fn=make_prefill_step(model, shape.seq_len), args=(params_shape, batch),
                        in_shardings=(pspecs, bshard), out_shardings=None, donate_argnums=())

    cache_shape = LM(cfg, device="meta").init_cache(shape.global_batch, shape.seq_len)
    cshard = cache_shardings(cache_shape, sizes, shape.global_batch)
    return CellSpec(fn=make_decode_step(model),
                    args=(params_shape, cache_shape, sds((shape.global_batch, 1), torch.int32),
                          sds((), torch.int32)),
                    in_shardings=(pspecs, cshard,
                                  shard_rules.batch_pspec(sizes, shape.global_batch,
                                                          extra_dims=1), ()),
                    out_shardings=(None, cshard), donate_argnums=(1,))


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec'd skip rules (DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 524k dense-KV decode is O(S^2); skipped per assignment"
    return True, ""


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
        return params, adamw_init(params), _place_batch(batch, self.batch_spec, self.mesh)

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


def _place_batch(batch, batch_spec, mesh):
    """Every leaf of a batch (full, the same on every rank) placed by its
    first dims' spec, the rest whole."""
    return {k: shard_rules.distribute(v, batch_spec + (None,) * (v.ndim - len(batch_spec)), mesh)
            for k, v in batch.items()}


@dataclasses.dataclass
class ShardedServeStep:
    """`make_prefill_step` or `make_decode_step` on a named `DeviceMesh`:
    the parameters placed by ``pspecs`` (`sharding.param_pspecs`), the
    batch (a prefill's tokens and context, a decode step's token) by
    ``batch_spec`` over its first dims, the cache by `cache_shardings` (a
    prefill makes it so: `LM.init_cache` on the parameters' mesh)."""

    model: LM
    mesh: object
    pspecs: Dict
    batch_spec: tuple
    step: Callable

    def place(self, params, batch):
        """(params, batch) as DTensors: each rank keeps its slice of the full
        trees it is given (no collective)."""
        return (shard_rules.distribute_tree(params, self.pspecs, self.mesh),
                _place_batch(batch, self.batch_spec, self.mesh))

    def __call__(self, *args):
        return self.step(*args)


def _serve_model(cfg: ModelConfig, mesh, global_batch: int, device):
    cfg = dataclasses.replace(cfg, act_shard_axes=act_axes(cfg, mesh, global_batch))
    shard_rules.carry_collectives(mesh)
    model = build_model(cfg, device=device or mesh.device_type)
    return model, shard_rules.param_pspecs(model.init_shapes(), mesh, pure_dp=cfg.pure_dp)


def make_sharded_prefill_step(cfg: ModelConfig, mesh, global_batch: int, max_len: int,
                              device=None) -> ShardedServeStep:
    """The prefill step of ``cfg`` on ``mesh`` for ``global_batch`` prompts
    and a cache of ``max_len`` positions (`build_cell`'s prefill cell): the
    batch over its data axes (``pure_dp``: and model) where they divide; the
    cache it returns placed by `cache_shardings`."""
    model, pspecs = _serve_model(cfg, mesh, global_batch, device)
    return ShardedServeStep(
        model=model, mesh=mesh, pspecs=pspecs,
        batch_spec=shard_rules.batch_pspec(mesh, global_batch, extra_dims=0,
                                           pure_dp=model.cfg.pure_dp),
        step=make_prefill_step(model, max_len))


def make_sharded_decode_step(cfg: ModelConfig, mesh, global_batch: int,
                             device=None) -> ShardedServeStep:
    """The decode step of ``cfg`` on ``mesh`` (`build_cell`'s decode cell):
    ``step(params, cache, token, pos)``, the token's rows over the data
    axes, the cache as `cache_shardings` places it, written and read on each
    rank's shard (a KV cache's T split over model never moves)."""
    model, pspecs = _serve_model(cfg, mesh, global_batch, device)
    return ShardedServeStep(model=model, mesh=mesh, pspecs=pspecs,
                            batch_spec=shard_rules.batch_pspec(mesh, global_batch, extra_dims=0),
                            step=make_decode_step(model))
