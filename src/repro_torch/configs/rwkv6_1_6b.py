"""RWKV6-1.6B "Finch" — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",  # rwkv is the linear-recurrence family in this zoo
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # 2048 / 64 per-head channels
    num_kv_heads=32,
    d_ff=7168,  # 3.5x channel-mix
    vocab_size=65536,
    head_dim=64,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
