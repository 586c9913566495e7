"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_head=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
)
