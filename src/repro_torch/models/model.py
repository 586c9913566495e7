"""The language model behind one interface, for every family of the configs.

A port of the JAX package's ``models/model.py``.  `LM(cfg, device)` exposes

  init(seed)                              -> params (float32 masters)
  forward(params, batch)                  -> (logits (B,S,V) float32, aux loss)
  loss(params, batch)                     -> scalar train loss
  init_cache(batch_size, max_len)         -> zeroed serving cache
  prefill(params, batch, max_len)         -> (last logits (B,V), cache)
  decode_step(params, cache, token, pos)  -> (logits (B,V), cache)

for the families ``dense``, ``moe``, ``ssm``, ``hybrid`` (Zamba-2),
``encdec`` (Whisper; conv frontend stubbed) and ``vlm`` (Llama-3.2-Vision;
vision frontend stubbed), with the JAX package's parameter and cache trees:
layer stacks are tensors with a leading layer axis, walked by a Python loop
(the JAX package scans them).  ``batch`` is {"tokens": (B,S) int}, with
"enc_frames" (B, encoder_seq, D) for ``encdec`` and "img_embeds"
(B, n_image_tokens, D) for ``vlm``.  ``forward`` returns the MoE layers'
summed Switch loss as ``aux`` (0 for the other families).

The serving path runs under ``torch.inference_mode``; ``decode_step``
updates the cache in place and returns it.  On a device mesh (DTensor
parameters, `launch.specs.make_sharded_prefill_step` and
``make_sharded_decode_step``) the cache is made on the parameters' mesh,
each leaf placed by `sharding.cache_pspecs` (a KV cache's T over
``model``), and written and read on each rank's shard: a prefill writes
each rank's slab of [0, S), a decode step's token goes to the rank that
holds its position, attention combines the ranks' partial softmaxes, the
SSM states advance head by head and channel by channel where they lie.
``forward`` and ``loss`` are differentiable: the stacked layers are
walked through one ``unbind`` a
stack, and under grad with ``cfg.remat`` each of the JAX package's remat
units (a block; a hybrid or vlm group) runs under
``torch.utils.checkpoint`` (`_units`).  Under grad the kernels' wrappers
take their autograd paths: flash, the forward kernel with the LSE and the
backward kernels; the SSD, the forward kernels keeping their scratch and
the four backward kernels, so every family trains on the card.  With
``use_kernels`` (the
default) the self-attention of a prefill or forward (the encoder's too)
goes through `flash_attention` and each Mamba-2 layer's SSD scan through
`ssd_log`, the hand-written kernels' wrappers (one launch per layer on the
card); without, through the JAX package's plain formulations.
Cross-attention, the MoE dispatch and decoding run in plain torch, as in
the JAX package.

``embed_scale`` (gemma) multiplies the embeddings by a float32 sqrt(d_model)
as the JAX package does, which promotes the residual stream to float32
under ``dtype="bfloat16"``: every layer then computes in float32 and only
the KV cache is stored in bf16.  The port keeps that semantic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.layers import (Init, embed_apply, embed_init, mlp_apply, rmsnorm,
                                       rmsnorm_init, sinusoidal_positions, torch_dtype,
                                       unembed_apply)
from repro_torch.models.ssm import init_ssm_state

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
AUX_LOSS_WEIGHT = 0.01
#: The stacked layer trees `_run` walks.
STACKS = ("blocks", "tail", "cross_blocks")


def _stack_init(init_fn, init: Init, n: int) -> Dict:
    """``n`` layers' parameters stacked on a leading axis, each layer drawn
    and copied into its slot in turn (at most the stack and one layer live)."""
    layer = init_fn(init)
    out = _tree_map(lambda x: x.new_empty((n,) + x.shape), layer)
    for i in range(n):
        if i:
            layer = init_fn(init)
        _tree_map(lambda dst, src: dst[i].copy_(src), out, layer)
    return out


def _shard_seq(x, cfg: ModelConfig):
    """Sequence-parallel residual stream (Korthikanti et al.): on a mesh,
    redistribute x (B,S,D) to (act axes, "model", None) between blocks, so
    that norms and pointwise work also split over the model axis (a
    dimension that does not divide stays whole)."""
    if not (cfg.seq_shard_activations and cfg.act_shard_axes):
        return x
    return sharding.redistribute(x, (tuple(cfg.act_shard_axes), "model", None))


def _nll(logits, labels, batch_axes=()):
    """-log_softmax(logits)[label] (B, S) of float32 logits (B, S, V), a
    label < 0 read as 0.  DTensor logits run on their local rows (split over
    ``batch_axes`` where they divide, the vocabulary gathered) through
    ``local_map``: gathering the labels' pick across ranks would gather the
    whole batch's log-probabilities."""
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        rows, rows2 = (sharding.placements(sharding.local_spec(mesh, batch_axes, logits.shape[0],
                                                               ndim), mesh) for ndim in (3, 2))
        return sharding.on_shards(_nll, mesh, (rows, rows2), rows2)(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or state tree (views, no copies;
    of a DTensor's shard too, `sharding.layer`)."""
    return _tree_map(lambda x: sharding.layer(x, i), tree)


def _unbind(tree):
    """Every layer of a stacked tree, each a tree of views, from one
    ``unbind(0)`` a leaf.  Under grad, indexing a stack layer by layer would
    give each layer's backward a zeros tensor the size of the whole stack;
    ``unbind``'s backward stacks the layers' gradients once."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(tree, DTensor) and not torch.is_grad_enabled():
        # DTensor's unbind takes no inference-mode views: views of the shard.
        return [sharding.layer(tree, i) for i in range(tree.shape[0])]
    return list(tree.unbind(0))


class LM:
    def __init__(self, cfg: ModelConfig, device="cuda", use_kernels: bool = True):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        if cfg.family == "vlm" and cfg.n_layers % cfg.cross_attn_period:
            raise ValueError("vlm: n_layers must be a multiple of cross_attn_period")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.dtype = torch_dtype(cfg.dtype)
        period = {"hybrid": cfg.shared_attn_period, "vlm": cfg.cross_attn_period}
        self.per = period.get(cfg.family, 1)
        self.groups = cfg.n_layers // self.per
        self.rem = cfg.n_layers - self.groups * self.per

    # ------------------------------------------------------------- init ---
    def init(self, seed: int = 0) -> Dict:
        """Random float32 parameters drawn on ``device`` from ``seed``."""
        cfg = self.cfg
        fam = cfg.family
        init = Init(seed, self.device)
        params = {
            "embed": embed_init(init, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings),
            "ln_f": rmsnorm_init(init, cfg.d_model),
        }
        if fam in ("dense", "vlm"):
            params["blocks"] = _stack_init(lambda i: B.attn_mlp_init(i, cfg), init, cfg.n_layers)
        elif fam == "moe":
            params["blocks"] = _stack_init(lambda i: B.moe_block_init(i, cfg), init, cfg.n_layers)
        elif fam == "ssm":
            params["blocks"] = _stack_init(lambda i: B.mamba_block_init(i, cfg), init,
                                           cfg.n_layers)
        elif fam == "hybrid":
            params["blocks"] = _stack_init(lambda i: B.mamba_block_init(i, cfg), init,
                                           self.groups * self.per)
            if self.rem:
                params["tail"] = _stack_init(lambda i: B.mamba_block_init(i, cfg), init,
                                             self.rem)
            params["shared_attn"] = B.attn_mlp_init(init, cfg)
        elif fam == "encdec":
            params["encoder"] = _stack_init(lambda i: B.attn_mlp_init(i, cfg), init,
                                            cfg.n_encoder_layers)
            params["ln_enc"] = rmsnorm_init(init, cfg.d_model)
            params["blocks"] = _stack_init(self._encdec_block_init, init, cfg.n_layers)
        if fam == "vlm":
            params["cross_blocks"] = _stack_init(
                lambda i: B.cross_block_init(i, cfg, with_mlp=False), init, self.groups)
        return params

    def init_shapes(self) -> Dict:
        """The parameter tree of `init` on the ``meta`` device: shapes, no values."""
        return LM(self.cfg, device="meta").init()

    def _encdec_block_init(self, init: Init) -> Dict:
        p = B.attn_mlp_init(init, self.cfg)
        p.update(ln_cross=rmsnorm_init(init, self.cfg.d_model),
                 cross=attn.cross_attn_init(init, self.cfg))
        return p

    # ---------------------------------------------------------- helpers ---
    def _embed(self, params, tokens, positions):
        """Token embeddings (scaled, plus sinusoids, as the config says)."""
        cfg = self.cfg
        x = embed_apply(params["embed"], tokens, self.dtype)
        if cfg.embed_scale:
            # A float32 factor, as the JAX package's numpy float32: promotes bf16.
            x = x.float() * float(np.sqrt(cfg.d_model).astype(np.float32))
        if cfg.pos_embed == "sinusoidal":
            x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        return x

    def _encode(self, params, enc_frames):
        """The Whisper encoder over stubbed conv-frontend output (B, Tenc, D):
        non-causal self-attention blocks (through the flash kernel's wrapper)."""
        cfg = self.cfg
        x = enc_frames.to(device=self.device, dtype=self.dtype)
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
        remat = self._remat()
        for lp in _unbind(params["encoder"]):
            x = self._maybe_remat(remat, B.attn_mlp_apply, lp, x, cfg, causal=False,
                                  use_kernel=self.use_kernels)
        return rmsnorm(params["ln_enc"], x)

    def _context(self, params, batch, x):
        """The cross-attention context of ``batch``: the encoded frames or the
        image embeddings (None for the families without one)."""
        if self.cfg.family == "encdec":
            return self._encode(params, batch["enc_frames"])
        if self.cfg.family == "vlm":
            return batch["img_embeds"].to(device=x.device, dtype=x.dtype)
        return None

    def _schedule(self):
        """The layer order: (kind, index) of every block.  Kinds: "mamba"
        and "tail" (Mamba-2 layers of the "blocks" and "tail" stacks),
        "shared" (the hybrid's shared block after group g), "dense", "moe",
        "encdec" (decoder layers of the "blocks" stack) and "cross" (the vlm's
        cross block g after each group)."""
        fam = self.cfg.family
        if fam in ("dense", "moe", "encdec", "ssm"):
            kind = "mamba" if fam == "ssm" else fam
            for i in range(self.cfg.n_layers):
                yield kind, i
            return
        inner, after = ("mamba", "shared") if fam == "hybrid" else ("dense", "cross")
        for g in range(self.groups):
            for j in range(self.per):
                yield inner, g * self.per + j
            yield after, g
        for i in range(self.rem):
            yield "tail", i

    def _states(self, cache, kind):
        """The {"conv", "ssm"} stacks a Mamba-2 layer of ``kind`` fills."""
        if self.cfg.family == "ssm":
            return cache
        return cache["mamba" if kind == "mamba" else "tail"]

    def _encdec_block(self, lp, x, ctx, return_kv):
        """A decoder layer: causal self-attention without RoPE, cross-attention
        to the encoder, MLP."""
        cfg = self.cfg
        res = attn.attend_full(lp["attn"], rmsnorm(lp["ln_attn"], x), cfg, causal=True,
                               use_rope=False, return_kv=return_kv,
                               use_kernel=self.use_kernels)
        h, kv = res if return_kv else (res, None)
        x = B.cross_block_apply({"ln_x": lp["ln_cross"], "cross": lp["cross"]}, x + h, ctx, cfg)
        x = x + mlp_apply(lp["mlp"], rmsnorm(lp["ln_mlp"], x), cfg.mlp_type)
        return x, kv

    def _remat(self) -> bool:
        """Recompute each remat unit in the backward: ``cfg.remat`` under grad."""
        return self.cfg.remat and torch.is_grad_enabled()

    @staticmethod
    def _maybe_remat(remat, fn, *args, **kwargs):
        """fn(*args) as it is, or under `torch.utils.checkpoint.checkpoint`
        (non-reentrant; nothing random to replay)."""
        if not remat:
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)

    def _units(self):
        """The blocks of `_schedule` grouped as the JAX package remats them
        (its ``_maybe_remat`` sites) -> [(blocks, remat)]: one block a unit,
        except a hybrid or vlm group (its layers and the shared or cross
        block after them), and the hybrid's tail blocks, which are not
        rematted."""
        units, cur = [], []
        for kind, i in self._schedule():
            if kind == "tail":
                units.append(([(kind, i)], False))
                continue
            cur.append((kind, i))
            if self.per == 1 or kind in ("shared", "cross"):
                units.append((cur, True))
                cur = []
        return units

    def _block(self, kind, i, lp, x, ctx, cache):
        """One block of kind ``kind`` with parameters ``lp``; fills layer
        ``i`` of ``cache`` when given.  -> (x, the MoE aux loss or None)."""
        cfg = self.cfg
        fill = cache is not None
        if kind in ("mamba", "tail"):
            if not fill:
                return B.mamba_block_apply(lp, x, cfg, use_kernel=self.use_kernels), None
            x, st = B.mamba_block_apply(lp, x, cfg, return_state=True,
                                        use_kernel=self.use_kernels)
            slot = self._states(cache, kind)
            sharding.write_layer(slot["conv"], i, st["conv"])
            sharding.write_layer(slot["ssm"], i, st["ssm"])
            return x, None
        if kind == "cross":
            x = B.cross_block_apply(lp, x, ctx, cfg)
            if fill:
                self._fill_cross(cache, i, B.cross_context_kv(lp, ctx, cfg))
            return x, None
        kv, aux = None, None
        if kind == "moe":
            res = B.moe_block_apply(lp, x, cfg, return_kv=fill, use_kernel=self.use_kernels)
            x, aux = res[:2]
            kv = res[2] if fill else None
        elif kind == "encdec":
            x, kv = self._encdec_block(lp, x, ctx, fill)
            if fill:
                self._fill_cross(cache, i, B.cross_context_kv(lp, ctx, cfg))
        else:
            res = B.attn_mlp_apply(lp, x, cfg, return_kv=fill, use_kernel=self.use_kernels)
            x, kv = res if fill else (res, None)
            if cfg.family == "dense" and not fill:
                x = _shard_seq(x, cfg)
        if fill:   # positions [0, S) of layer i
            slot = cache["shared"] if kind == "shared" else cache
            sharding.write_layer(slot["k"], i, kv[0], dim=1)
            sharding.write_layer(slot["v"], i, kv[1], dim=1)
        return x, aux

    @staticmethod
    def _fill_cross(cache, i, kv):
        sharding.write_layer(cache["cross_k"], i, kv[0])
        sharding.write_layer(cache["cross_v"], i, kv[1])

    def _unit(self, blocks, layers, x, ctx, cache=None):
        """The blocks of one remat unit in order -> (x, their summed aux or None)."""
        aux = None
        for kind, i in blocks:
            x, a = self._block(kind, i, layers[kind][i], x, ctx, cache)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _run(self, params, x, ctx=None, cache=None):
        """Every block over x (B,S,D); fills ``cache`` when given.  -> (x, aux).

        The stacked layers are walked through one ``unbind`` a stack; under
        grad with ``cfg.remat`` each unit of `_units` runs under
        `torch.utils.checkpoint.checkpoint`, so the backward keeps only the
        units' inputs and recomputes the rest.
        """
        stacks = {name: _unbind(params[name]) for name in STACKS if name in params}
        layers = {"mamba": stacks.get("blocks"), "tail": stacks.get("tail"),
                  "cross": stacks.get("cross_blocks")}
        for kind in ("dense", "moe", "encdec"):
            layers[kind] = stacks.get("blocks")
        if "shared_attn" in params:
            layers["shared"] = [params["shared_attn"]] * self.groups
        remat = cache is None and self._remat()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blocks, unit_remat in self._units():
            x, a = self._maybe_remat(remat and unit_remat, self._unit, blocks, layers, x, ctx,
                                     cache)
            if a is not None:
                aux = aux + a
        return x, aux

    # ------------------------------------------------------------ train ---
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward -> (logits float32 (B,S,V), aux loss)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens, torch.arange(tokens.shape[1], device=tokens.device))
        x, aux = self._run(params, x, self._context(params, batch, x))
        x = rmsnorm(params["ln_f"], x)
        return unembed_apply(params["embed"], x, self.cfg.logit_softcap), aux

    def loss(self, params, batch) -> torch.Tensor:
        """The training loss, the JAX package's ``LM.loss``: the mean next-token
        NLL over the positions whose label is >= 0 (``log_softmax`` of the
        float32 logits), plus ``AUX_LOSS_WEIGHT`` times the MoE aux loss."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"].long()
        nll = _nll(logits, labels, self.cfg.act_shard_axes)
        del logits
        mask = (labels >= 0).float()
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return loss + AUX_LOSS_WEIGHT * aux

    # ---------------------------------------------------------- serving ---
    def init_cache(self, batch_size: int, max_len: int, mesh=None) -> Dict:
        """The zeroed serving cache; on a ``mesh`` its leaves are DTensors
        placed by `sharding.cache_pspecs`, each rank's shard made alone."""
        if mesh is not None:
            shapes = LM(self.cfg, device="meta").init_cache(batch_size, max_len)
            specs = sharding.cache_pspecs(shapes, mesh, batch_size)
            return _tree_map(lambda x, spec: sharding.zeros(x.shape, spec, mesh, x.dtype,
                                                            self.device), shapes, specs)
        cfg = self.cfg
        fam = cfg.family

        def states(n):
            st = init_ssm_state(cfg, batch_size, self.dtype, self.device)
            return {k: v.expand((n,) + v.shape).clone() for k, v in st.items()}

        def stacked(tree, n):
            return {k: v.expand((n,) + v.shape).clone() for k, v in tree.items()}

        if fam == "ssm":
            return states(cfg.n_layers)
        kv = init_kv_cache(cfg, batch_size, max_len, self.dtype, self.device)
        if fam == "hybrid":
            cache = {"mamba": states(self.groups * self.per), "shared": stacked(kv, self.groups)}
            if self.rem:
                cache["tail"] = states(self.rem)
            return cache
        cache = stacked(kv, cfg.n_layers)
        if fam in ("encdec", "vlm"):
            n, t = ((cfg.n_layers, cfg.encoder_seq) if fam == "encdec"
                    else (self.groups, cfg.n_image_tokens))
            shape = (n, batch_size, t, cfg.n_kv_heads, cfg.head_dim)
            cache["cross_k"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
            cache["cross_v"] = torch.zeros_like(cache["cross_k"])
        return cache

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: int) -> Tuple[torch.Tensor, Dict]:
        """Teacher-forced pass that also fills the serving cache (on the
        parameters' mesh when they are DTensors: `init_cache`)."""
        tokens = batch["tokens"]
        if tokens.shape[1] > max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds max_len {max_len}")
        leaf = params["ln_f"]["scale"]
        cache = self.init_cache(tokens.shape[0], max_len,
                                leaf.device_mesh if isinstance(leaf, DTensor) else None)
        x = self._embed(params, tokens, torch.arange(tokens.shape[1], device=tokens.device))
        x, _ = self._run(params, x, self._context(params, batch, x), cache)
        x = rmsnorm(params["ln_f"], x[:, -1:])
        logits = unembed_apply(params["embed"], x, self.cfg.logit_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, params, cache, token, pos) -> Tuple[torch.Tensor, Dict]:
        """token: (B, 1) int; pos: its position.  Returns (logits (B,V), cache),
        the cache updated in place."""
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(params, token, torch.full((1,), pos, device=token.device))
        for kind, i in self._schedule():
            if kind in ("mamba", "tail"):
                slot = self._states(cache, kind)
                lp = _layer(params["blocks" if kind == "mamba" else "tail"], i)
                x, st = B.mamba_block_decode(lp, x, _layer(slot, i), cfg)
                sharding.write_layer(slot["conv"], i, st["conv"])
                sharding.write_layer(slot["ssm"], i, st["ssm"])
                continue
            if kind == "cross":
                x = B.cross_block_decode_cached(_layer(params["cross_blocks"], i), x,
                                                *self._cross(cache, i), cfg)
                continue
            slot = cache["shared"] if kind == "shared" else cache
            kv = {"k": sharding.layer(slot["k"], i), "v": sharding.layer(slot["v"], i)}
            lp = params["shared_attn"] if kind == "shared" else _layer(params["blocks"], i)
            if kind == "moe":
                x, _ = B.moe_block_decode(lp, x, kv, pos, cfg)
            elif kind == "encdec":
                h, _ = attn.attend_decode(lp["attn"], rmsnorm(lp["ln_attn"], x), kv, pos, cfg)
                x = B.cross_block_decode_cached({"ln_x": lp["ln_cross"], "cross": lp["cross"]},
                                                x + sharding.match(h, x), *self._cross(cache, i),
                                                cfg)
                x = x + mlp_apply(lp["mlp"], rmsnorm(lp["ln_mlp"], x), cfg.mlp_type)
            else:
                x, _ = B.attn_mlp_decode(lp, x, kv, pos, cfg)
        x = rmsnorm(params["ln_f"], x)
        return unembed_apply(params["embed"], x, cfg.logit_softcap)[:, 0], cache

    @staticmethod
    def _cross(cache, i):
        return sharding.layer(cache["cross_k"], i), sharding.layer(cache["cross_v"], i)


def build_model(cfg: ModelConfig, device="cuda", use_kernels: bool = True) -> LM:
    return LM(cfg, device=device, use_kernels=use_kernels)
