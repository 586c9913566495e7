"""mamba2-130m — attention-free SSD [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    tie_embeddings=True,
    pure_dp=True,          # §Perf C1: 16-way model axis -> extra DP
    ssm_chunk=256,         # §Perf C3: state-carry traffic shrinks with L
)
