"""Model / run configuration.

One frozen dataclass describes every assigned architecture; families select
block composition in `repro.models.model`:

  dense   — decoder-only transformer (GQA/MQA, SwiGLU/GeGLU)
  moe     — dense + mixture-of-experts MLP
  ssm     — attention-free Mamba-2 (SSD)
  hybrid  — Mamba-2 backbone + shared attention block (Zamba-2)
  encdec  — encoder-decoder (Whisper; conv frontend stubbed)
  vlm     — decoder + cross-attention layers to image tokens (Llama-3.2-V)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads
    # --- layer flavor ---
    mlp_type: str = "swiglu"              # swiglu | geglu | gelu
    qkv_bias: bool = False
    pos_embed: str = "rope"               # rope | sinusoidal
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # tokens (Mixtral: 4096)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "onehot"              # onehot (GShard baseline) | scatter
    act_shard_axes: tuple = ()            # mesh data axes (set by launcher)
    pure_dp: bool = False                 # treat model axis as extra DP (small archs)
    param_mode: str = "fsdp"              # fsdp | zero1 (bf16 replicated compute params)
    seq_shard_activations: bool = False   # sequence-parallel residual stream
    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_chunk: int = 64
    conv_width: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssd_intra_dtype: str = "float32"      # intra-chunk math dtype (bf16 = perf)
    # --- hybrid (Zamba-2): one shared attn+MLP block every N ssm layers ---
    shared_attn_period: int = 6
    # --- encoder-decoder (Whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0                  # precomputed frame embeddings
    # --- VLM (Llama-3.2-Vision) ---
    cross_attn_period: int = 0            # every Nth layer gets cross-attn
    n_image_tokens: int = 0
    # --- numerics / training ---
    dtype: str = "bfloat16"               # activation/compute dtype
    param_dtype: str = "float32"          # master params
    remat: bool = True
    scan_layers: bool = True              # False: unroll (cost-model probes)
    force_dense_attn: bool = False        # probes: exact-flops dense attention
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    logit_softcap: Optional[float] = None

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> can run long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and roofline)."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        mlp = gates * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "dense":
            return self.n_layers * (attn + mlp) + emb
        if self.family == "moe":
            return self.n_layers * (attn + self.n_experts * mlp + d * self.n_experts) + emb
        if self.family == "ssm":
            ssm = self._ssm_block_params()
            return self.n_layers * ssm + emb
        if self.family == "hybrid":
            ssm = self._ssm_block_params()
            shared = attn + mlp
            return self.n_layers * ssm + shared + emb
        if self.family == "encdec":
            enc = self.n_encoder_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)  # self + cross
            return enc + dec + emb
        if self.family == "vlm":
            n_cross = self.n_layers // max(self.cross_attn_period, 1)
            return self.n_layers * (attn + mlp) + n_cross * attn + emb
        raise ValueError(self.family)

    def _ssm_block_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        in_proj = d * (2 * di + 2 * n + self.n_ssm_heads)
        conv = (di + 2 * n) * self.conv_width
        out_proj = di * d
        return in_proj + conv + out_proj

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dh = self.head_dim
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        mlp = gates * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + self.top_k * mlp + d * self.n_experts) + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
