"""Shared building blocks: RMSNorm, RoPE, SwiGLU, GQA attention, embeddings.

The port of `repro.models.layers`, with the same parameter layout (plain
dicts of tensors), the same maths and the same dtype casts:

    params = *_init(generator, ..., device=)    # weights drawn from a torch.Generator
    y = *_apply(params, x, ...)

Attention goes through `kernels.ops`: the hand-written kernels for CUDA
tensors (K4 for a full sequence or a cross-attention over an encoder's
memory, K5 for one decode token), their plain
PyTorch versions for CPU tensors.  The large projections stay
`torch.matmul`, as the reference leaves them to XLA; an int8 weight
(`repro_torch.quant`) is dequantised into the compute dtype just before its
product.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale).to(dtype)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# -------------------------------------------------------------------- RoPE
def rope_tables(positions, head_dim: int, theta: float = 10000.0):
    """(cos, sin) of the split-half rotary angles, float32, shaped
    (..., S, 1, Dh/2) to broadcast over the heads.  positions: (..., S) int.
    Computed once a forward or decode step and shared by its layers."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    angles = positions[..., None].float() * (1.0 / (theta ** (exponents / head_dim)))
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, rope):
    """Split-half rotary embedding of x (..., S, H, Dh) by ``rope_tables``' (cos, sin)."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- Linear
def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False, dtype=torch.float32,
                scale=None, device=None):
    p = {"w": _normal(gen, (d_in, d_out), d_in**-0.5 if scale is None else scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dequantize_weight(w, dtype):
    """The matrix of an int8 ``{"q", "s"}`` weight (`repro_torch.quant`) in
    ``dtype``: ``q`` and ``s`` each cast to ``dtype``, their product rounded
    there, as the reference's `linear_apply` computes it (the product in
    place: one matrix in ``dtype`` at a time, not two)."""
    return w["q"].to(dtype).mul_(w["s"].to(dtype))


def linear_apply(p, x):
    w = p["w"]
    y = x @ (dequantize_weight(w, x.dtype) if isinstance(w, dict) else w.to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ------------------------------------------------------------ SwiGLU MLP
def mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32, device=None):
    return {
        "gate": linear_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "up": linear_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "down": linear_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def mlp_apply(p, x):
    h = F.silu(linear_apply(p["gate"], x)) * linear_apply(p["up"], x)
    return linear_apply(p["down"], h)


# ------------------------------------------------------- GQA attention
class AttnConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # None = full causal
    causal: bool = True  # False for encoder self-attention


def attn_init(gen, cfg: AttnConfig, dtype=torch.float32, device=None):
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    p = {
        "wq": linear_init(gen, d, h * dh, **kw),
        "wk": linear_init(gen, d, kvh * dh, **kw),
        "wv": linear_init(gen, d, kvh * dh, **kw),
        "wo": linear_init(gen, h * dh, d, dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, dtype, device)
        p["k_norm"] = rmsnorm_init(dh, dtype, device)
    return p


def _project_qkv(p, cfg: AttnConfig, x, rope):
    B, S, _ = x.shape
    q = linear_apply(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = linear_apply(p["wk"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = linear_apply(p["wv"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    return apply_rope(q, rope), apply_rope(k, rope), v


def attn_apply(p, cfg: AttnConfig, x, rope):
    """Self-attention over a full sequence (prefill): K4 on the card.

    rope: ``rope_tables`` of positions 0..S-1."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, rope)
    o = kops.attention(q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window)
    return linear_apply(p["wo"], o.reshape(B, S, cfg.num_heads * cfg.head_dim))


def cross_attn_apply(p, cfg: AttnConfig, x, memory):
    """Cross-attention: queries from x (B, S, d), keys and values from the
    encoder's memory (B, Sm, d); no RoPE, every memory row visible (K4
    non-causal with Sq = S, Skv = Sm on the card)."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    q = linear_apply(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = linear_apply(p["wk"], memory).reshape(B, Sm, cfg.num_kv_heads, cfg.head_dim)
    v = linear_apply(p["wv"], memory).reshape(B, Sm, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    o = kops.attention(q, k, v, causal=False, sliding_window=None)
    return linear_apply(p["wo"], o.reshape(B, S, cfg.num_heads * cfg.head_dim))


# --------------------------------------------------- decode-time attention
def decode_tables(cfg: AttnConfig, pos: int, cache_len: int, device):
    """What every layer of one decode step shares: the RoPE tables at ``pos``
    and the cache's (cache_len,) validity mask.

    For sliding-window configs the cache is a ring buffer of length
    ``cache_len`` written at pos % cache_len, masked by absolute position
    distance; otherwise slots 0..pos are valid."""
    rope = rope_tables(torch.full((1, 1), pos, dtype=torch.int64, device=device),
                       cfg.head_dim, cfg.rope_theta)
    idx = torch.arange(cache_len, device=device)
    if cfg.sliding_window is not None:
        # ring buffer: slot i holds the absolute position a with a % S == i and
        # a <= pos, i.e. a = i + S * floor((pos - i) / S) when valid.
        abs_pos = idx + cache_len * torch.div(pos - idx, cache_len, rounding_mode="floor")
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (pos - abs_pos < cfg.sliding_window)
    else:
        valid = idx <= pos
    return rope, valid


def attn_decode_apply(p, cfg: AttnConfig, x, k_cache, v_cache, pos: int, tables):
    """One-token decode against a KV cache: K5 on the card.

    x: (B, 1, d); k_cache/v_cache: (B, S_cache, KVH, Dh); pos: the current
    absolute position (an int); tables: ``decode_tables(cfg, pos, S_cache)``.
    Unlike the reference, which returns new
    caches from `dynamic_update_slice`, the caches are written IN PLACE
    (``k_cache[:, slot] = k``); they are returned as well, so the result
    reads as the reference's ``(out, k_new, v_new)``.
    """
    B = x.shape[0]
    S_cache = k_cache.shape[1]
    rope, valid = tables
    q, k, v = _project_qkv(p, cfg, x, rope)

    slot = pos % S_cache if cfg.sliding_window is not None else pos
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)

    o = kops.decode_attention(q, k_cache, v_cache, valid)  # (B, 1, H, Dh)
    out = linear_apply(p["wo"], o.reshape(B, 1, cfg.num_heads * cfg.head_dim))
    return out, k_cache, v_cache


# ------------------------------------------------------------- embeddings
def embed_init(gen, vocab: int, d_model: int, dtype=torch.float32, device=None):
    return {"emb": _normal(gen, (vocab, d_model), d_model**-0.5, dtype, device)}


def embed_apply(p, tokens):
    """The rows of ``tokens``; for int8 rows (per-row scales) their float32
    values ``q s``, which the callers cast to the compute dtype."""
    emb = p["emb"]
    if isinstance(emb, dict):
        return emb["q"][tokens].to(torch.float32) * emb["s"][:, 0][tokens][..., None]
    return emb[tokens]


def unembed_apply(p_head, x):
    """lm head: x (B,S,D) -> logits (B,S,V), computed via matmul."""
    return linear_apply(p_head, x)


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0):
    """Token-mean cross entropy in float32 (labels: int, -1 = ignore)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.clamp(min=0)[..., None], dim=-1)[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse**2
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
