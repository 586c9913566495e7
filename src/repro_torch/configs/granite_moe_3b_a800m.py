"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8
[hf:ibm-granite]. The assignment line says 40e top-8 / d_ff=512 (its comment
mentions 32e); we implement the line literally — see DESIGN.md §6."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    moe_impl="shard_map",  # §Perf A4: ~10,000x on the dominant term
)
