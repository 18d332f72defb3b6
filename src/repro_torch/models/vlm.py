"""VLM backbone (InternVL2-76B style): the port of `repro.models.vlm`.

An InternLM2-flavoured GQA decoder (the dense family's, `models.transformer`)
that reads projected vision-patch embeddings before the text.  The vision
tower (InternViT-6B) is a stub, as in the reference: the model takes
precomputed patch embeddings (B, P, vision_dim) and implements the MLP
projector (RMSNorm over ``vision_dim``, fc1, GELU in its tanh form, fc2) and
the decoder.  A forward runs the dense stack over the P + S sequence
``[patches, text]`` at RoPE positions 0..P+S-1, causal over both (K4 on the
card, K4b under autograd), and returns logits over all of it; `loss_labels`
masks the patch prefix out of the loss.  Decode is the dense family's: the
reference's server feeds text prompts alone, so no step reads patches.

`project_patches` and `loss_labels` are looked up at call time, so a caller
can rebind them (chip_smoke.py plants faults there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.models.transformer import (
    dense_cache_init,
    dense_decode_step,
    dense_forward,
    dense_init,
)

# InternViT-6B's output width (the projector's input side).
DEFAULT_VISION_DIM = 3200


def vlm_init(gen: torch.Generator, cfg: ModelConfig, device,
             vision_dim: int = DEFAULT_VISION_DIM):
    """The dense decoder's tree (drawn first, as the reference's ``k_lm``),
    then ``projector``: ``ln`` ones over ``vision_dim``, ``fc1``
    (vision_dim, d_model) and ``fc2`` (d_model, d_model) drawn in that order."""
    dtype = getattr(torch, cfg.param_dtype)
    p = dense_init(gen, cfg, device)
    p["projector"] = {
        "ln": nn.rmsnorm_init(vision_dim, dtype, device),
        "fc1": nn.linear_init(gen, vision_dim, cfg.d_model, dtype=dtype, device=device),
        "fc2": nn.linear_init(gen, cfg.d_model, cfg.d_model, dtype=dtype, device=device),
    }
    return p


def project_patches(params, cfg: ModelConfig, patches):
    """patches: (B, P, vision_dim) -> (B, P, d_model).  The GELU is
    `jax.nn.gelu`'s default, the tanh approximation."""
    proj = params["projector"]
    h = nn.rmsnorm_apply(proj["ln"], patches, cfg.norm_eps)
    h = F.gelu(nn.linear_apply(proj["fc1"], h), approximate="tanh")
    return nn.linear_apply(proj["fc2"], h)


def vlm_forward(params, cfg: ModelConfig, patches, tokens):
    """patches (B, P, vision_dim), tokens (B, S) -> logits (B, P + S, V) over
    the whole sequence, patches first; callers mask the patch positions."""
    cdt = getattr(torch, cfg.compute_dtype)
    vis = project_patches(params, cfg, patches.to(cdt))
    txt = nn.embed_apply(params["embed"], tokens).to(cdt)
    return dense_forward(params, cfg, inputs_embeds=torch.cat([vis, txt], dim=1))


def loss_labels(labels, patches):
    """The labels (B, S) over the (patches + text) logits: -1 (ignored) at
    the P patch positions, then the text's."""
    pad = torch.full((labels.shape[0], patches.shape[1]), -1, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([pad, labels], dim=1)


# decode: the dense family's (text prompts fed token by token).
vlm_cache_init = dense_cache_init
vlm_decode_step = dense_decode_step
