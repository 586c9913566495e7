"""whisper-large-v3 — enc-dec; conv frontend stubbed (precomputed frames)
[arXiv:2212.04356]. Decoder shapes follow the assignment, not the real
448-token ceiling (DESIGN.md §6)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    pos_embed="sinusoidal",
)
