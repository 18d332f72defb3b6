"""Dense GQA decoder-only transformer (llama3 / qwen2 / qwen3 / granite family).

The port of `repro.models.transformer`.  Layer parameters keep the
reference's *stacked* layout (every leaf of ``params["layers"]`` has a
leading (L, ...) axis); the reference's `lax.scan` over layers is a Python
loop over that axis.  Sharding annotations (a no-op on one card) and remat
(training) are not carried: a training forward keeps every layer's
activations, which fit one card at the sizes this port trains.

Each forward takes the per-layer views with one `torch.unbind` of every
stacked leaf, not ``t[i]`` per layer: under autograd a select's backward
allocates a zero tensor the size of the whole stack for each layer, while
unbind's backward stacks the layers' gradients once.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as nn
from repro_torch.utils.tree import tree_leaves, tree_map


def _attn_cfg(cfg: ModelConfig, causal: bool = True) -> nn.AttnConfig:
    """``cfg``'s attention; ``causal=False`` for the audio family's encoder
    self-attention and its cross-attention."""
    return nn.AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window,
        causal=causal,
    )


def layer_params(layers) -> list:
    """Every layer's parameters, as views into the stacked (L, ...) leaves:
    one `torch.unbind` of each leaf."""
    unbound = tree_map(torch.unbind, layers)  # leaves: tuples of L views
    n = len(tree_leaves(unbound)[0])
    return [tree_map(lambda views, i=i: views[i], unbound) for i in range(n)]


def _layer_init(gen, cfg: ModelConfig, dtype, device):
    return {
        "ln1": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": nn.attn_init(gen, _attn_cfg(cfg), dtype, device),
        "ln2": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": nn.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def stacked_init(n: int, draw):
    """``n`` layers drawn in turn by ``draw()``, each copied into leaves
    allocated once at their stacked (n, ...) shape: the values of
    `torch.stack` over the same draws, without a second copy of the weights
    (32 layers of internvl2-76b are 55 GB in bf16)."""
    stack = None
    for i in range(n):
        one = draw()
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((n, *t.shape)), one)
        tree_map(lambda dst, src, i=i: dst[i].copy_(src), stack, one)
        del one
    return stack


def dense_init(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = getattr(torch, cfg.param_dtype)
    embed = nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    layers = stacked_init(cfg.num_layers, lambda: _layer_init(gen, cfg, dtype, device))
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device),
    }


def _layer_apply(lp, cfg: ModelConfig, x, rope):
    acfg = _attn_cfg(cfg)
    x = x + nn.attn_apply(lp["attn"], acfg, nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps), rope)
    return x + nn.mlp_apply(lp["mlp"], nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))


def dense_forward(params, cfg: ModelConfig, tokens=None, *, inputs_embeds=None):
    """tokens: (B, S) int -> logits (B, S, V); or precomputed
    ``inputs_embeds`` (B, S, d_model) in place of the tokens' embeddings (the
    vlm family's patches and text), at RoPE positions 0..S-1."""
    cdt = getattr(torch, cfg.compute_dtype)
    if inputs_embeds is None:
        x = nn.embed_apply(params["embed"], tokens).to(cdt)
    else:
        x = inputs_embeds.to(cdt)
    rope = nn.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.head_dim, cfg.rope_theta)
    for lp in layer_params(params["layers"]):
        x = _layer_apply(lp, cfg, x, rope)
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)


# ----------------------------------------------------------------- decode
def dense_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                     device=None):
    """KV cache (L, B, S, KVH, Dh) of zeros.  For sliding-window configs the
    cache is a ring buffer of length min(cache_len, window)."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def dense_decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position. One-token decode.

    Returns (logits (B, V), cache); the cache is updated in place."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], token[:, None]).to(cdt)  # (B,1,D)
    acfg = _attn_cfg(cfg)
    tables = nn.decode_tables(acfg, pos, cache["k"].shape[2], x.device)
    for i, lp in enumerate(layer_params(params["layers"])):
        h = nn.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = nn.attn_decode_apply(lp["attn"], acfg, h, cache["k"][i], cache["v"][i], pos,
                                       tables)
        x = x + a
        x = x + nn.mlp_apply(lp["mlp"], nn.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps))
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)[:, 0], cache
