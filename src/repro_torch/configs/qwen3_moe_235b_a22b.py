"""Qwen3-MoE-235B-A22B — 128 experts, top-8, qk-norm GQA [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,  # per-expert ffn width (fine-grained)
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_tok=8,
    num_shared_experts=0,
    moe_d_ff=1536,
    first_dense_layers=0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
