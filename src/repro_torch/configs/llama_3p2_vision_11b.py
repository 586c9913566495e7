"""llama-3.2-vision-11b — decoder + cross-attn image layers every 5th layer;
vision frontend stubbed (precomputed patch embeddings) [hf:meta-llama]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_period=5,
    n_image_tokens=1600,
)
