"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54 layer slots, one shared attention+MLP block invoked every 6th slot with
per-site LoRA (rank 128) on q/k/v/o; the remaining slots are Mamba2 layers
(state 64, head dim 64, expand 2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,  # MHA in the shared block
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_num_heads=80,  # expand*d_model / head_dim = 5120/64
    ssm_expand=2,
    attn_every=6,
    hybrid_lora_rank=128,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
