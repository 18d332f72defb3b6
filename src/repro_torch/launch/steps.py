"""Inference steps on one card: the port of `repro.launch.steps`'
`make_prefill_step` and `make_serve_step`.

The reference lowers both onto a device mesh with parameter, batch and cache
shardings; on one H100 the mesh and the shardings are dropped and the maths
is the same:

    prefill = make_prefill_step(cfg)            # (params, {"tokens": (B, S)}) -> (B, V)
    serve = make_serve_step(cfg)                # (params, cache, token, pos) -> (logits, cache)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, *, device=None):
    """Full-sequence forward (flash attention, K4, in every layer); the step
    returns the last position's logits (B, V)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params, batch):
        logits, _ = M.forward(params, cfg, {"tokens": torch.as_tensor(batch["tokens"], device=dev)})
        return logits[:, -1]

    return step


def make_serve_step(cfg: ModelConfig, *, device=None):
    """One-token decode (decode attention, K5, in every layer):
    (params, cache, token (B,), pos) -> (logits (B, V), cache updated in place)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params, cache, token, pos):
        return M.decode_step(params, cfg, torch.as_tensor(token, device=dev), cache, pos)

    return step
