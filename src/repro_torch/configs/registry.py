"""Architecture registry: --arch <id> -> ModelConfig."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3p2_vision_11b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses

    cfg = get_config(arch)
    return dataclasses.replace(
        cfg,
        n_layers=4 if cfg.family == "hybrid" else 2,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=16 if cfg.d_head else None,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_chunk=8,
        ssm_head_dim=16,
        sliding_window=8 if cfg.sliding_window else None,
        cross_attn_period=2 if cfg.cross_attn_period else 0,
        n_image_tokens=8 if cfg.n_image_tokens else 0,
        shared_attn_period=2,
        rope_theta=cfg.rope_theta,
        dtype="float32",
        remat=False,
    )
