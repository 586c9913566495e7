"""The language model behind one interface, for the hybrid (Zamba-2) family.

A port of the JAX package's ``models/model.py``.  `LM(cfg, device)` exposes

  init(seed)                              -> params (float32 masters)
  forward(params, batch)                  -> (logits (B,S,V) float32, aux)
  init_cache(batch_size, max_len)         -> zeroed serving cache
  prefill(params, batch, max_len)         -> (last logits (B,V), cache)
  decode_step(params, cache, token, pos)  -> (logits (B,V), cache)

with the JAX package's parameter and cache trees: layer stacks are tensors
with a leading layer axis, walked by a Python loop (the JAX package scans
them).  ``batch`` is {"tokens": (B,S) int}.  The serving path runs under
``torch.inference_mode``; ``decode_step`` updates the cache in place and
returns it.  With ``use_kernels`` (the default) the prefill's attention and
SSD scans go through the hand-written kernels' wrappers (on the card, one
``flash_attention`` launch per shared block and one ``ssd_log`` launch per
Mamba-2 layer); without, through the JAX package's plain formulations.
Decoding runs neither kernel, as in the JAX package.  The other families
raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import init_kv_cache
from repro_torch.models.layers import (Init, embed_apply, embed_init, rmsnorm, rmsnorm_init,
                                       torch_dtype, unembed_apply)
from repro_torch.models.ssm import init_ssm_state

#: Where each family that is not ported yet stands in ROADMAP.md.
UNPORTED = {
    "dense": "ROADMAP queue 1 step 14 (the dense family)",
    "ssm": "ROADMAP queue 1 step 14 (the ssm family)",
    "moe": "ROADMAP queue 1 step 14 (MoE, models/moe.py)",
    "vlm": "ROADMAP queue 1 step 14 (cross-attention: vlm)",
    "encdec": "ROADMAP queue 1 step 14 (cross-attention: encdec)",
}


def _stack_init(init_fn, init: Init, n: int) -> Dict:
    """``n`` layers' parameters stacked on a leading axis."""
    layers = [init_fn(init) for _ in range(n)]
    return _tree_map(lambda *xs: torch.stack(xs), *layers)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or state tree (views, no copies)."""
    return _tree_map(lambda x: x[i], tree)


class LM:
    def __init__(self, cfg: ModelConfig, device="cuda", use_kernels: bool = True):
        if cfg.family != "hybrid":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: {UNPORTED.get(cfg.family, '?')}")
        if cfg.pos_embed != "rope" or cfg.embed_scale:
            raise NotImplementedError("the hybrid path takes RoPE and unscaled embeddings")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.dtype = torch_dtype(cfg.dtype)
        self.groups = cfg.n_layers // cfg.shared_attn_period
        self.rem = cfg.n_layers - self.groups * cfg.shared_attn_period

    # ------------------------------------------------------------- init ---
    def init(self, seed: int = 0) -> Dict:
        """Random float32 parameters drawn on ``device`` from ``seed``."""
        cfg = self.cfg
        init = Init(seed, self.device)
        params = {
            "embed": embed_init(init, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings),
            "ln_f": rmsnorm_init(init, cfg.d_model),
            "blocks": _stack_init(lambda i: B.mamba_block_init(i, cfg), init,
                                  self.groups * cfg.shared_attn_period),
        }
        if self.rem:
            params["tail"] = _stack_init(lambda i: B.mamba_block_init(i, cfg), init, self.rem)
        params["shared_attn"] = B.attn_mlp_init(init, cfg)
        return params

    # --------------------------------------------------------- layers ---
    def _schedule(self):
        """The layer order: (stack name, index) of every Mamba-2 layer, and
        ("shared", g) for the shared block after each full group g."""
        per = self.cfg.shared_attn_period
        for g in range(self.groups):
            for j in range(per):
                yield "blocks", g * per + j
            yield "shared", g
        for i in range(self.rem):
            yield "tail", i

    def _run(self, params, x, cache=None):
        """The hybrid stack over x (B,S,D); fills ``cache`` when given."""
        cfg = self.cfg
        s = x.shape[1]
        for stack, i in self._schedule():
            if stack == "shared":
                res = B.attn_mlp_apply(params["shared_attn"], x, cfg,
                                       return_kv=cache is not None, use_kernel=self.use_kernels)
                if cache is None:
                    x = res
                    continue
                x, (k, v) = res
                cache["shared"]["k"][i, :, :s] = k
                cache["shared"]["v"][i, :, :s] = v
                continue
            lp = _layer(params[stack], i)
            if cache is None:
                x = B.mamba_block_apply(lp, x, cfg, use_kernel=self.use_kernels)
                continue
            x, st = B.mamba_block_apply(lp, x, cfg, return_state=True,
                                        use_kernel=self.use_kernels)
            slot = cache["mamba" if stack == "blocks" else "tail"]
            slot["conv"][i] = st["conv"]
            slot["ssm"][i] = st["ssm"]
        return x

    # ------------------------------------------------------------ train ---
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward -> (logits float32 (B,S,V), aux loss 0)."""
        x = embed_apply(params["embed"], batch["tokens"], self.dtype)
        x = self._run(params, x)
        x = rmsnorm(params["ln_f"], x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return unembed_apply(params["embed"], x, self.cfg.logit_softcap), aux

    # ---------------------------------------------------------- serving ---
    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        cfg = self.cfg
        per = cfg.shared_attn_period

        def states(n):
            st = init_ssm_state(cfg, batch_size, self.dtype, self.device)
            return {k: v.expand((n,) + v.shape).clone() for k, v in st.items()}

        kv = init_kv_cache(cfg, batch_size, max_len, self.dtype, self.device)
        cache = {
            "mamba": states(self.groups * per),
            "shared": {k: v.expand((self.groups,) + v.shape).clone() for k, v in kv.items()},
        }
        if self.rem:
            cache["tail"] = states(self.rem)
        return cache

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: int) -> Tuple[torch.Tensor, Dict]:
        """Teacher-forced pass that also fills the serving cache."""
        tokens = batch["tokens"]
        if tokens.shape[1] > max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds max_len {max_len}")
        cache = self.init_cache(tokens.shape[0], max_len)
        x = embed_apply(params["embed"], tokens, self.dtype)
        x = self._run(params, x, cache)
        x = rmsnorm(params["ln_f"], x[:, -1:])
        logits = unembed_apply(params["embed"], x, self.cfg.logit_softcap)
        return logits[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, params, cache, token, pos) -> Tuple[torch.Tensor, Dict]:
        """token: (B, 1) int; pos: its position.  Returns (logits (B,V), cache),
        the cache updated in place."""
        cfg = self.cfg
        pos = int(pos)
        x = embed_apply(params["embed"], token, self.dtype)
        for stack, i in self._schedule():
            if stack == "shared":
                kv = {"k": cache["shared"]["k"][i], "v": cache["shared"]["v"][i]}
                x, _ = B.attn_mlp_decode(params["shared_attn"], x, kv, pos, cfg)
                continue
            slot = cache["mamba" if stack == "blocks" else "tail"]
            x, st = B.mamba_block_decode(_layer(params[stack], i), x, _layer(slot, i), cfg)
            slot["conv"][i] = st["conv"]
            slot["ssm"][i] = st["ssm"]
        x = rmsnorm(params["ln_f"], x)
        return unembed_apply(params["embed"], x, cfg.logit_softcap)[:, 0], cache


def build_model(cfg: ModelConfig, device="cuda", use_kernels: bool = True) -> LM:
    return LM(cfg, device=device, use_kernels=use_kernels)
