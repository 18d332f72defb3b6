"""InternVL2-76B — InternViT + InternLM2 [arXiv:2404.16821].

Language backbone only (InternLM2-72B-style decoder); the InternViT-6B vision
tower is a stub, as in the reference: the model takes precomputed patch
embeddings (vision_dim=3200) through the MLP projector.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=1_000_000.0,
    frontend_len=1024,  # vision patches per sample
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
