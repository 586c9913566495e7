"""Pre-norm residual blocks of the hybrid (Zamba-2) family.

Ports of the JAX package's ``models/blocks.py`` for ``attn_mlp`` (the shared
attention + MLP block) and ``mamba`` (the Mamba-2 block); the MoE and
cross-attention blocks wait for their families.  ``use_kernel`` selects the
hand-written kernels' path (`attention.attend_full`, `ssm.mamba2_apply`).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init


# ------------------------------------------------------------- attn + mlp ---
def attn_mlp_init(init: Init, cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": rmsnorm_init(init, cfg.d_model),
        "attn": attn.attn_init(init, cfg),
        "ln_mlp": rmsnorm_init(init, cfg.d_model),
        "mlp": mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp_type),
    }


def attn_mlp_apply(params, x, cfg: ModelConfig, positions=None, causal=True,
                   return_kv=False, use_kernel=True):
    res = attn.attend_full(params["attn"], rmsnorm(params["ln_attn"], x), cfg,
                           positions=positions, causal=causal, return_kv=return_kv,
                           use_kernel=use_kernel)
    h, kv = res if return_kv else (res, None)
    x = x + h
    x = x + mlp_apply(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return (x, kv) if return_kv else x


def attn_mlp_decode(params, x, cache, pos, cfg: ModelConfig):
    h, cache = attn.attend_decode(params["attn"], rmsnorm(params["ln_attn"], x), cache, pos,
                                  cfg)
    x = x + h
    return x + mlp_apply(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type), cache


# ----------------------------------------------------------------- mamba ---
def mamba_block_init(init: Init, cfg: ModelConfig) -> Dict:
    return {"ln": rmsnorm_init(init, cfg.d_model), "mamba": ssm_mod.mamba2_init(init, cfg)}


def mamba_block_apply(params, x, cfg: ModelConfig, return_state=False, use_kernel=True):
    res = ssm_mod.mamba2_apply(params["mamba"], rmsnorm(params["ln"], x), cfg,
                               return_state=return_state, use_kernel=use_kernel)
    if return_state:
        h, st = res
        return x + h, st
    return x + res


def mamba_block_decode(params, x, state, cfg: ModelConfig):
    h, state = ssm_mod.mamba2_decode(params["mamba"], rmsnorm(params["ln"], x), state, cfg)
    return x + h, state
