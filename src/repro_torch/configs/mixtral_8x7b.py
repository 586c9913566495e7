"""mixtral-8x7b — 8 experts top-2, sliding-window attn [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    moe_impl="shard_map",  # §Perf A4: 62x on the dominant (collective) term
)
