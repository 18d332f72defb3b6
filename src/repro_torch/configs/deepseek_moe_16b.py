"""DeepSeekMoE-16B — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066].  Layer 0 is dense (d_ff=10944); layers 1-27 are MoE with
per-expert width 1408 (the assigned spec's d_ff refers to the expert width).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,  # the single leading dense layer
    vocab_size=102400,
    head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
