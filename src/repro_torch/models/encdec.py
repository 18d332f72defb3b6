"""Encoder-decoder audio backbone (seamless-m4t style): the port of `repro.models.encdec`.

The modality frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the reference: the model takes precomputed frame embeddings (B, F,
d_model).  The backbone that consumes them is a non-causal self-attention
encoder (RoPE at frame positions 0..F-1) and a causal decoder with
cross-attention over the encoder's memory (no RoPE).

The parameter layout is the reference's: ``enc_layers`` and ``dec_layers``
leaves stacked (L, ...), its `lax.scan`s over layers Python loops over views
of those stacks (`transformer.layer_params`); remat is not carried, as for
the other families.  On the card every attention goes through the
hand-written kernels (`kernels.ops`): K4 (and K4b under autograd) for the
encoder's self-attention (non-causal, Sq = Skv = F), the decoder's
self-attention (causal) and its cross-attention (non-causal, Sq = S, Skv =
F); K5 at decode, over the token cache and over the cross cache, which
`encdec_cache_init` fills once from the memory and no step writes.

`cross_valid` is looked up at call time, as `_attn_cfg` and
`layers.cross_attn_apply` are, so a caller can rebind them (chip_smoke.py
plants faults there).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models.transformer import _attn_cfg, layer_params, stacked_init


# ------------------------------------------------------------------ init
def _enc_layer_init(gen, cfg: ModelConfig, dtype, device):
    return {
        "ln1": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": nn.attn_init(gen, _attn_cfg(cfg, causal=False), dtype, device),
        "ln2": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": nn.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _dec_layer_init(gen, cfg: ModelConfig, dtype, device):
    return {
        "ln1": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "self_attn": nn.attn_init(gen, _attn_cfg(cfg), dtype, device),
        "ln_x": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "cross_attn": nn.attn_init(gen, _attn_cfg(cfg, causal=False), dtype, device),
        "ln2": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": nn.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig, device):
    """The encoder's layers, the decoder's, the embedding, the head: drawn
    in the order of the reference's keys (k_e, k_d, k_emb, k_h), laid out
    under its leaf names and in its order."""
    dtype = getattr(torch, cfg.param_dtype)
    enc = stacked_init(cfg.encoder_layers, lambda: _enc_layer_init(gen, cfg, dtype, device))
    dec = stacked_init(cfg.num_layers, lambda: _dec_layer_init(gen, cfg, dtype, device))
    embed = nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    head = nn.linear_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device)
    return {
        "enc_layers": enc,
        "enc_ln_f": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "embed": embed,
        "dec_layers": dec,
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "head": head,
    }


# --------------------------------------------------------------- forward
def encode(params, cfg: ModelConfig, frames):
    """frames: (B, F, d_model) precomputed frame embeddings -> memory (B, F, d_model)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = frames.to(cdt)
    rope = nn.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                          cfg.rope_theta)
    acfg = _attn_cfg(cfg, causal=False)
    for lp in layer_params(params["enc_layers"]):
        h = nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        x = x + nn.attn_apply(lp["attn"], acfg, h, rope)
        x = x + nn.mlp_apply(lp["mlp"], nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))
    return nn.rmsnorm_apply(params["enc_ln_f"], x, cfg.norm_eps)


def encdec_forward(params, cfg: ModelConfig, frames, tokens):
    """Teacher-forced forward: frames (B, F, d_model), tokens (B, S) -> logits (B, S, V)."""
    memory = encode(params, cfg, frames)
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], tokens).to(cdt)
    rope = nn.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                          cfg.rope_theta)
    acfg = _attn_cfg(cfg)
    xcfg = _attn_cfg(cfg, causal=False)
    for lp in layer_params(params["dec_layers"]):
        h = nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        x = x + nn.attn_apply(lp["self_attn"], acfg, h, rope)
        h = nn.rmsnorm_apply(lp["ln_x"], x, cfg.norm_eps)
        x = x + nn.cross_attn_apply(lp["cross_attn"], xcfg, h, memory)
        x = x + nn.mlp_apply(lp["mlp"], nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)


# ----------------------------------------------------------------- decode
def encdec_cache_init(params, cfg: ModelConfig, frames, cache_len: int, dtype=torch.bfloat16,
                      device=None):
    """Runs the encoder once and fills every decoder layer's cross K/V
    (L, B, F, KVH, Dh): each projected from the memory in the compute dtype,
    then cast to the cache's ``dtype``, in that order; the token cache
    (L, B, cache_len, KVH, Dh) zeros."""
    memory = encode(params, cfg, frames.to(device))
    B, F, _ = memory.shape
    L, KVH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cross_k = torch.empty((L, B, F, KVH, Dh), dtype=dtype, device=memory.device)
    cross_v = torch.empty_like(cross_k)
    for i, lp in enumerate(layer_params(params["dec_layers"])):
        ca = lp["cross_attn"]
        cross_k[i] = nn.linear_apply(ca["wk"], memory).reshape(B, F, KVH, Dh).to(dtype)
        cross_v[i] = nn.linear_apply(ca["wv"], memory).reshape(B, F, KVH, Dh).to(dtype)
    shape = (L, B, cache_len, KVH, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=memory.device),
            "v": torch.zeros(shape, dtype=dtype, device=memory.device),
            "cross_k": cross_k, "cross_v": cross_v}


def cross_valid(frames: int, device):
    """The cross cache's validity mask: every frame."""
    return torch.ones((frames,), dtype=torch.bool, device=device)


def encdec_decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position.  One-token decode: the
    decoder's self-attention over the token cache (written at ``pos`` in
    place), its cross-attention over the cross cache with every frame valid.

    Returns (logits (B, V), cache)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], token[:, None]).to(cdt)  # (B,1,D)
    acfg = _attn_cfg(cfg)
    B = x.shape[0]
    H, Dh = cfg.num_heads, cfg.head_dim
    tables = nn.decode_tables(acfg, pos, cache["k"].shape[2], x.device)
    valid_x = cross_valid(cache["cross_k"].shape[2], x.device)
    for i, lp in enumerate(layer_params(params["dec_layers"])):
        h = nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = nn.attn_decode_apply(lp["self_attn"], acfg, h, cache["k"][i], cache["v"][i],
                                       pos, tables)
        x = x + a
        h = nn.rmsnorm_apply(lp["ln_x"], x, cfg.norm_eps)
        ca = lp["cross_attn"]
        q = nn.linear_apply(ca["wq"], h).reshape(B, 1, H, Dh)
        o = kops.decode_attention(q, cache["cross_k"][i], cache["cross_v"][i], valid_x)
        x = x + nn.linear_apply(ca["wo"], o.reshape(B, 1, H * Dh))
        x = x + nn.mlp_apply(lp["mlp"], nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)[:, 0], cache
