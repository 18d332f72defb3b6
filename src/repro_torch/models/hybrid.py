"""Zamba2-style hybrid: the port of `repro.models.hybrid`.

A Mamba-2 backbone and ONE shared attention+MLP block invoked every
`attn_every` layers, specialised at each site by rank-r LoRA deltas on the
q/k/v/o projections [arXiv:2411.15242].  G = num_layers // attn_every
groups, each (attn_every - 1) Mamba-2 layers followed by the shared block.
As in the reference, the residual wiring is standard pre-norm (not Zamba2's
concat-with-embedding).

The parameter layout is the reference's: ``mamba_layers`` leaves are
stacked ``(G, per_group, ...)``, ``loras`` leaves ``(G, ...)``; its
`lax.scan`s over groups and layers are Python loops over views of those
stacks.  Attention goes through `kernels.ops`: K4 over a full sequence, K5
at decode; the Mamba-2 scan through K6 (`models.ssm`).  The LoRA products
and the projections stay `torch.matmul`, as the reference leaves them to
XLA.  Training differentiates the scan through K6 and K6b and attention
through K4 and K4b; remat is not carried: a backward pass keeps every
layer's activations.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models.ssm import mamba_apply, mamba_decode_step, mamba_init, mamba_state_init
from repro_torch.models.transformer import _attn_cfg, _stack, layer_params
from repro_torch.utils.tree import tree_map


def _lora_init(gen, d_in, d_out, rank, dtype, device):
    return {
        "a": nn._normal(gen, (d_in, rank), d_in**-0.5, dtype, device),
        "b": torch.zeros((rank, d_out), dtype=dtype, device=device),
    }


def _lora_apply(lp, x):
    return (x @ lp["a"].to(x.dtype)) @ lp["b"].to(x.dtype)


def _site_lora_init(gen, cfg: ModelConfig, dtype, device):
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r = cfg.hybrid_lora_rank
    return {
        "q": _lora_init(gen, d, h * dh, r, dtype, device),
        "k": _lora_init(gen, d, kvh * dh, r, dtype, device),
        "v": _lora_init(gen, d, kvh * dh, r, dtype, device),
        "o": _lora_init(gen, h * dh, d, r, dtype, device),
    }


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(G, per_group): attention sites, and Mamba-2 layers before each."""
    return cfg.num_layers // cfg.attn_every, cfg.attn_every - 1


def hybrid_init(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = getattr(torch, cfg.param_dtype)
    G, per_group = _groups(cfg)
    embed = nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    mamba = _stack([mamba_init(gen, cfg, dtype, device) for _ in range(G * per_group)])
    mamba = tree_map(lambda t: t.reshape(G, per_group, *t.shape[1:]), mamba)
    loras = _stack([_site_lora_init(gen, cfg, dtype, device) for _ in range(G)])
    return {
        "embed": embed,
        "mamba_layers": mamba,  # leaves (G, per_group, ...)
        "shared": {
            "ln1": nn.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": nn.attn_init(gen, _attn_cfg(cfg), dtype, device),
            "ln2": nn.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": nn.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
        },
        "loras": loras,  # leaves (G, ...)
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device),
    }


def _sites(params, cfg: ModelConfig):
    """[(mamba layers of group g, LoRA of site g)] as views into the stacks."""
    G, per_group = _groups(cfg)
    mamba = layer_params(tree_map(lambda t: t.flatten(0, 1), params["mamba_layers"]))
    loras = layer_params(params["loras"])
    return [(mamba[g * per_group:(g + 1) * per_group], loras[g]) for g in range(G)]


def _lora_qkv(ap, lora, acfg: nn.AttnConfig, h, rope):
    """q, k, v of the shared projections plus the site's LoRA deltas, rotated."""
    B, S, _ = h.shape
    q = (nn.linear_apply(ap["wq"], h) + _lora_apply(lora["q"], h)).reshape(
        B, S, acfg.num_heads, acfg.head_dim)
    k = (nn.linear_apply(ap["wk"], h) + _lora_apply(lora["k"], h)).reshape(
        B, S, acfg.num_kv_heads, acfg.head_dim)
    v = (nn.linear_apply(ap["wv"], h) + _lora_apply(lora["v"], h)).reshape(
        B, S, acfg.num_kv_heads, acfg.head_dim)
    return nn.apply_rope(q, rope), nn.apply_rope(k, rope), v


def _shared_out(shared, lora, cfg: ModelConfig, x, o):
    """The attention output's projection (plus LoRA), the residual, the MLP."""
    ap = shared["attn"]
    x = x + (nn.linear_apply(ap["wo"], o) + _lora_apply(lora["o"], o))
    return x + nn.mlp_apply(shared["mlp"], nn.rmsnorm_apply(shared["ln2"], x, cfg.norm_eps))


def _shared_attn_apply(shared, lora, cfg: ModelConfig, x, rope):
    """The shared block over a full sequence (K4), with the site's LoRA."""
    acfg = _attn_cfg(cfg)
    B, S, _ = x.shape
    h = nn.rmsnorm_apply(shared["ln1"], x, cfg.norm_eps)
    q, k, v = _lora_qkv(shared["attn"], lora, acfg, h, rope)
    o = kops.attention(q, k, v, causal=True, sliding_window=acfg.sliding_window)
    return _shared_out(shared, lora, cfg, x, o.reshape(B, S, acfg.num_heads * acfg.head_dim))


def hybrid_forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int -> logits (B, S, V)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], tokens).to(cdt)
    rope = nn.rope_tables(torch.arange(x.shape[1], device=x.device), cfg.head_dim, cfg.rope_theta)
    for mamba_g, lora in _sites(params, cfg):
        for mp in mamba_g:
            x = mamba_apply(mp, cfg, x)
        x = _shared_attn_apply(params["shared"], lora, cfg, x, rope)
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)


# ----------------------------------------------------------------- decode
def hybrid_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                      device=None):
    """Mamba-2 states for every layer, ``(G, per_group, ...)``, in float32,
    and a KV cache ``(G, B, S, KVH, Dh)`` in ``dtype`` per attention site: a
    ring buffer of min(cache_len, window) slots for sliding-window configs."""
    G, per_group = _groups(cfg)
    s = mamba_state_init(cfg, batch, device=device)
    states = {k: torch.zeros((G, per_group, *v.shape), dtype=v.dtype, device=device)
              for k, v in s.items()}
    kv_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    kv_shape = (G, batch, kv_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "mamba": states,
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
    }


def _shared_attn_decode(shared, lora, cfg: ModelConfig, x, kc, vc, pos: int, tables):
    """The shared block for one token (K5) against the site's cache, written
    in place at the token's slot."""
    acfg = _attn_cfg(cfg)
    B = x.shape[0]
    rope, valid = tables
    h = nn.rmsnorm_apply(shared["ln1"], x, cfg.norm_eps)
    q, k, v = _lora_qkv(shared["attn"], lora, acfg, h, rope)
    slot = pos % kc.shape[1] if cfg.sliding_window is not None else pos
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    o = kops.decode_attention(q, kc, vc, valid)
    return _shared_out(shared, lora, cfg, x, o.reshape(B, 1, acfg.num_heads * acfg.head_dim))


def hybrid_decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    """token: (B,) int; pos: absolute position.  Returns (logits (B, V),
    cache); the cache (Mamba-2 states and KV) is updated in place."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], token[:, None]).to(cdt)  # (B, 1, D)
    tables = nn.decode_tables(_attn_cfg(cfg), pos, cache["k"].shape[2], x.device)
    conv, ssm = cache["mamba"]["conv"], cache["mamba"]["ssm"]
    for g, (mamba_g, lora) in enumerate(_sites(params, cfg)):
        for j, mp in enumerate(mamba_g):
            x, _ = mamba_decode_step(mp, cfg, x, {"conv": conv[g, j], "ssm": ssm[g, j]})
        x = _shared_attn_decode(params["shared"], lora, cfg, x, cache["k"][g], cache["v"][g],
                                pos, tables)
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)[:, 0], cache
