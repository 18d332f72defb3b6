"""Uniform model API — the port of `repro.models.model` for the dense,
hybrid (zamba2), ssm (rwkv6) and moe (deepseek-moe, qwen3-moe) families.

    params = init_params(cfg, generator, device=)  # weights from a torch.Generator
    logits, aux = forward(params, cfg, batch)        # batch: {tokens (B,S), labels (B,S)}
    loss = loss_fn(params, cfg, batch)               # scalar, float32: ce + 0.01 aux
    cache = init_decode_cache(cfg, batch_size, cache_len, device=)
    logits, cache = decode_step(params, cfg, token, cache, pos)

The ssm family's decode cache is its recurrent state (token shifts and WKV
states, float32, constant in the sequence length): it ignores ``cache_len``
and ``dtype``, as the reference's does.

Every other family of the zoo raises `NotImplementedError` until its slice
of the port lands.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid, moe, rwkv, transformer
from repro_torch.models import layers as nn

MOE_AUX_WEIGHT = 0.01


def _zero_aux(forward):
    """A family's forward returning (logits, aux) with aux 0: only the moe
    family has a load-balance loss."""
    def fwd(params, cfg, tokens):
        logits = forward(params, cfg, tokens)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    return fwd


# family -> (init, forward -> (logits, aux), cache_init, decode_step)
_FAMILIES = {
    "dense": (transformer.dense_init, _zero_aux(transformer.dense_forward),
              transformer.dense_cache_init, transformer.dense_decode_step),
    "hybrid": (hybrid.hybrid_init, _zero_aux(hybrid.hybrid_forward),
               hybrid.hybrid_cache_init, hybrid.hybrid_decode_step),
    "ssm": (rwkv.rwkv_init, _zero_aux(rwkv.rwkv_forward), rwkv.rwkv_cache_init,
            rwkv.rwkv_decode_step),
    "moe": (moe.moe_init, moe.moe_forward, moe.moe_cache_init, moe.moe_decode_step),
}


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet")
    return _FAMILIES[cfg.family]


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *, device=None):
    """Random weights as the reference draws them (normal * d_in**-0.5,
    norms 1, biases 0; the hybrid family's SSM and LoRA leaves and the ssm
    family's time-mix leaves as `models.ssm`, `models.hybrid` and
    `models.rwkv` say; the moe family's stacks drawn into place, layer by
    layer, `models.moe`), from ``generator`` (default: seed 0 on ``device``),
    on ``device`` (default CUDA)."""
    init = _family(cfg)[0]
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    return init(gen, cfg, dev)


def forward(params, cfg: ModelConfig, batch):
    """Returns (logits, aux): aux the moe family's load-balance loss averaged
    over its MoE layers, 0 for the other families."""
    return _family(cfg)[1](params, cfg, batch["tokens"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Cross entropy plus ``MOE_AUX_WEIGHT`` times the load-balance loss."""
    logits, aux = forward(params, cfg, batch)
    return nn.cross_entropy_loss(logits, batch["labels"]) + MOE_AUX_WEIGHT * aux


def init_decode_cache(cfg: ModelConfig, batch_size: int, cache_len: int, *,
                      dtype=torch.bfloat16, device=None):
    return _family(cfg)[2](cfg, batch_size, cache_len, dtype, resolve_device(device))


def decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position. Returns (logits (B, V), cache),
    the cache updated in place."""
    return _family(cfg)[3](params, cfg, token, cache, int(pos))
