"""Uniform model API — the port of `repro.models.model` for the dense family.

    params = init_params(cfg, generator, device=)  # weights from a torch.Generator
    logits, aux = forward(params, cfg, batch)        # batch: {tokens (B,S), labels (B,S)}
    loss = loss_fn(params, cfg, batch)               # scalar, float32
    cache = init_decode_cache(cfg, batch_size, cache_len, device=)
    logits, cache = decode_step(params, cfg, token, cache, pos)

Every other family of the zoo raises `NotImplementedError` until its slice
of the port lands.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as nn
from repro_torch.models import transformer


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet")


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *, device=None):
    """Random weights as the reference draws them (normal * d_in**-0.5,
    norms 1, biases 0), from ``generator`` (default: seed 0 on ``device``),
    on ``device`` (default CUDA)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    return transformer.dense_init(gen, cfg, dev)


def forward(params, cfg: ModelConfig, batch):
    """Returns (logits, aux); aux is the MoE load-balance loss, 0 here."""
    _dense_only(cfg)
    logits = transformer.dense_forward(params, cfg, batch["tokens"])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params, cfg: ModelConfig, batch):
    logits, _ = forward(params, cfg, batch)
    return nn.cross_entropy_loss(logits, batch["labels"])


def init_decode_cache(cfg: ModelConfig, batch_size: int, cache_len: int, *,
                      dtype=torch.bfloat16, device=None):
    _dense_only(cfg)
    return transformer.dense_cache_init(cfg, batch_size, cache_len, dtype, resolve_device(device))


def decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position. Returns (logits (B, V), cache),
    the cache updated in place."""
    _dense_only(cfg)
    return transformer.dense_decode_step(params, cfg, token, cache, int(pos))
