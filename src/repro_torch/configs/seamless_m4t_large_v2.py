"""SeamlessM4T-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596].

Speech encoder (24L, the transformer form of the conformer stack) + text
decoder (24L with cross-attention).  The mel-spectrogram + conv feature
frontend is a stub: the model takes frame embeddings (B, F, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=24,  # decoder depth
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    frontend_len=1024,  # audio frames per sample (train shapes)
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
