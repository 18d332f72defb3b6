"""Llama-3.2-3B — small llama3 [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
