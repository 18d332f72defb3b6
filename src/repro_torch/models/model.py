"""Uniform model API — the port of `repro.models.model` for every family of
the zoo: dense, hybrid (zamba2), ssm (rwkv6), moe (deepseek-moe, qwen3-moe),
audio (seamless-m4t) and vlm (internvl2).

    params = init_params(cfg, generator, device=)  # weights from a torch.Generator
    logits, aux = forward(params, cfg, batch)        # batch: {tokens (B,S), labels (B,S)}
    loss = loss_fn(params, cfg, batch)               # scalar, float32: ce + 0.01 aux
    cache = init_decode_cache(cfg, batch_size, cache_len, device=)
    logits, cache = decode_step(params, cfg, token, cache, pos)

The audio family's batches add ``frames`` (B, F, d_model), the precomputed
frame embeddings its encoder reads, and its decode cache is built from them
(``init_decode_cache(..., params=, batch={"frames": ...})``: the encoder runs
once and fills the cross-attention cache).

The vlm family's batches add ``patches`` (B, P, vision_dim), the
precomputed vision-patch embeddings its projector reads: the logits cover
the P patches and the text, and `loss_fn` masks the patch positions out.
Its decode is the dense family's (text tokens only).

The ssm family's decode cache is its recurrent state (token shifts and WKV
states, float32, constant in the sequence length): it ignores ``cache_len``
and ``dtype``, as the reference's does.

An unknown family raises `ValueError`, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, moe, rwkv, transformer, vlm
from repro_torch.models import layers as nn

MOE_AUX_WEIGHT = 0.01


def _zero_aux(forward, *keys):
    """A family's forward of ``batch[k] for k in keys`` returning (logits,
    aux) with aux 0: only the moe family has a load-balance loss."""
    def fwd(params, cfg, batch):
        logits = forward(params, cfg, *(batch[k] for k in keys))
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    return fwd


# family -> (init, forward(params, cfg, batch) -> (logits, aux), cache_init, decode_step)
_FAMILIES = {
    "dense": (transformer.dense_init, _zero_aux(transformer.dense_forward, "tokens"),
              transformer.dense_cache_init, transformer.dense_decode_step),
    "hybrid": (hybrid.hybrid_init, _zero_aux(hybrid.hybrid_forward, "tokens"),
               hybrid.hybrid_cache_init, hybrid.hybrid_decode_step),
    "ssm": (rwkv.rwkv_init, _zero_aux(rwkv.rwkv_forward, "tokens"), rwkv.rwkv_cache_init,
            rwkv.rwkv_decode_step),
    "moe": (moe.moe_init, lambda params, cfg, batch: moe.moe_forward(params, cfg, batch["tokens"]),
            moe.moe_cache_init, moe.moe_decode_step),
    "audio": (encdec.encdec_init, _zero_aux(encdec.encdec_forward, "frames", "tokens"),
              encdec.encdec_cache_init, encdec.encdec_decode_step),
    "vlm": (vlm.vlm_init, _zero_aux(vlm.vlm_forward, "patches", "tokens"), vlm.vlm_cache_init,
            vlm.vlm_decode_step),
}


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return _FAMILIES[cfg.family]


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *, device=None):
    """Random weights as the reference draws them (normal * d_in**-0.5,
    norms 1, biases 0; the hybrid family's SSM and LoRA leaves and the ssm
    family's time-mix leaves as `models.ssm`, `models.hybrid` and
    `models.rwkv` say; the moe family's stacks drawn into place, layer by
    layer, `models.moe`, as the dense decoder's are; the audio family's
    encoder, decoder, embedding and head in the reference's key order,
    `models.encdec`; the vlm family's decoder, then its projector,
    `models.vlm`), from ``generator``
    (default: seed 0 on ``device``),
    on ``device`` (default CUDA)."""
    init = _family(cfg)[0]
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    return init(gen, cfg, dev)


def forward(params, cfg: ModelConfig, batch):
    """Returns (logits, aux): aux the moe family's load-balance loss averaged
    over its MoE layers, 0 for the other families.  ``batch`` holds
    ``tokens``, and for the audio family ``frames`` too, for the vlm family
    ``patches`` (its logits then cover the P patches and the text)."""
    return _family(cfg)[1](params, cfg, batch)


def loss_fn(params, cfg: ModelConfig, batch):
    """Cross entropy plus ``MOE_AUX_WEIGHT`` times the load-balance loss; in
    the vlm family the patch positions are masked out (`vlm.loss_labels`)."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        labels = vlm.loss_labels(labels, batch["patches"])
    return nn.cross_entropy_loss(logits, labels) + MOE_AUX_WEIGHT * aux


def init_decode_cache(cfg: ModelConfig, batch_size: int, cache_len: int, *,
                      dtype=torch.bfloat16, device=None, params=None, batch=None):
    """The family's decode cache for ``batch_size`` rows.  The audio family's
    runs the encoder over ``batch["frames"]`` (``batch_size`` rows) with
    ``params`` and fills the cross-attention cache from its memory; it
    raises without them."""
    cache_init = _family(cfg)[2]
    dev = resolve_device(device)
    if cfg.family != "audio":
        return cache_init(cfg, batch_size, cache_len, dtype, dev)
    if params is None or batch is None or "frames" not in batch:
        raise ValueError(f"{cfg.name}: the audio cache runs the encoder: pass params= and "
                         f"batch={{'frames': (B, F, d_model)}}")
    frames = torch.as_tensor(batch["frames"])
    if frames.ndim != 3 or frames.shape[0] != batch_size or frames.shape[2] != cfg.d_model:
        raise ValueError(f"{cfg.name}: frames {tuple(frames.shape)} are not ({batch_size}, F, "
                         f"{cfg.d_model})")
    return cache_init(params, cfg, frames, cache_len, dtype, dev)


def decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position. Returns (logits (B, V), cache),
    the cache updated in place."""
    return _family(cfg)[3](params, cfg, token, cache, int(pos))
