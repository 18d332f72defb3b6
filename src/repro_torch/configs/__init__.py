"""Architecture registry of the port: `get_config("<arch-id>")`.

Every architecture of the zoo is ported: the dense family, the hybrid
family (zamba2), the ssm family (rwkv6), the moe family (deepseek-moe,
qwen3-moe), the audio family (seamless-m4t) and the vlm family (internvl2).
An unknown name raises `KeyError`, as the reference's registry does.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_moe_16b,
    granite_3_2b,
    internvl2_76b,
    llama3_2_3b,
    qwen2_1_5b,
    qwen3_4b,
    qwen3_moe_235b_a22b,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
    zamba2_2_7b,
)
from repro_torch.configs.base import ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [qwen2_1_5b.CONFIG, granite_3_2b.CONFIG, llama3_2_3b.CONFIG, qwen3_4b.CONFIG,
              zamba2_2_7b.CONFIG, rwkv6_1_6b.CONFIG, deepseek_moe_16b.CONFIG,
              qwen3_moe_235b_a22b.CONFIG, seamless_m4t_large_v2.CONFIG,
              internvl2_76b.CONFIG]
}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["ARCH_IDS", "ModelConfig", "REGISTRY", "get_config"]
