"""RWKV-6 "Finch" (attention-free, data-dependent decay) [arXiv:2404.05892]:
the port of `repro.models.rwkv`.

Time-mix block: token-shift lerps, low-rank data-dependent decay
w_t = exp(-exp(w0 + tanh(x W_a) W_b)), per-head WKV recurrence (the kernel),
an RMSNorm over the whole width (the reference's, not the published
per-head GroupNorm) gated by silu(g).  Channel-mix block: shifted
squared-ReLU FFN.

The WKV recurrence goes through `kernels.ops.rwkv6_scan` (K7 on the card,
its plain version on the CPU) on both serving paths: over the whole
sequence at prefill, and with T = 1 from the carried state at decode.  The
projections stay `torch.matmul`, as the reference leaves them to XLA.

The parameter layout is the reference's: every leaf of ``params["layers"]``
is stacked ``(L, ...)`` and the reference's `lax.scan` over layers is a
Python loop over views of the stacks.  Precision follows the reference: the
decay is formed in float32 from bf16 products and rounded to the compute
dtype before the scan; ``w0`` and ``u`` are float32 leaves; the decode
shift states and ``wkv`` are float32.  Training differentiates the scan
through K7 and K7b (`kernels.ops.rwkv6_scan`); remat and the sharding
annotations are not carried: a backward pass keeps every layer's
activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn
from repro_torch.models.transformer import layer_params, stacked_init

_DECAY_RANK = 64


def rwkv_dims(cfg: ModelConfig):
    H = cfg.num_heads
    K = cfg.d_model // H  # head dim (rwkv6: 64)
    return H, K


def _shift(x, x_prev=None):
    """Token shift: x[t-1] (zeros / carried state at t=0). x: (B, T, D)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def timemix_init(gen, cfg: ModelConfig, dtype, device=None):
    """One layer's time-mix parameters, drawn as the reference draws them
    (mu uniform in [0, 1), w0 = -4, w_b scaled by 0.01, u normal * 0.1);
    ``w0`` and ``u`` are float32 whatever ``dtype`` is."""
    d = cfg.d_model
    H, K = rwkv_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def linear(d_in, d_out, **kw):
        return nn.linear_init(gen, d_in, d_out, dtype=dtype, device=device, **kw)

    return {
        "ln": nn.rmsnorm_init(d, dtype, device),
        "mu": torch.rand((5, d), generator=gen, **f32).to(dtype),  # r, k, v, w, g
        "w0": torch.full((d,), -4.0, **f32),
        "w_a": linear(d, _DECAY_RANK),
        "w_b": linear(_DECAY_RANK, d, scale=0.01),
        "wr": linear(d, d),
        "wk": linear(d, d),
        "wv": linear(d, d),
        "wg": linear(d, d),
        "u": torch.randn((H, K), generator=gen, **f32) * 0.1,
        "ln_out": nn.rmsnorm_init(d, dtype, device),
        "wo": linear(d, d),
    }


def _timemix_core(p, cfg: ModelConfig, x, xx):
    """Shared between full-sequence and decode: r, k, v, w (per head) and
    g from x and its shifted version xx."""
    B, T, _ = x.shape
    H, K = rwkv_dims(cfg)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xx - x) * mu[i] for i in range(5))
    r = nn.linear_apply(p["wr"], xr)
    k = nn.linear_apply(p["wk"], xk)
    v = nn.linear_apply(p["wv"], xv)
    g = F.silu(nn.linear_apply(p["wg"], xg))
    # data-dependent decay: both products in the compute dtype, the sum in float32
    w_raw = p["w0"] + nn.linear_apply(p["w_b"], torch.tanh(nn.linear_apply(p["w_a"], xw))).float()
    w = torch.exp(-torch.exp(w_raw))  # decay factor in (0, 1)

    def heads(a):
        return a.reshape(B, T, H, K)

    return heads(r), heads(k), heads(v), heads(w.to(x.dtype)), g


def timemix_apply(p, cfg: ModelConfig, x, shift_state=None, wkv_state=None, wkv_out=None):
    """x: (B, T, D). Returns (out, new_shift_state, new_wkv_state); the new
    WKV state is written into ``wkv_out`` when given (it may be
    ``wkv_state`` itself)."""
    h = nn.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
    xx = _shift(h, shift_state)
    r, k, v, w, g = _timemix_core(p, cfg, h, xx)
    y, S = kops.rwkv6_scan(r, k, v, w, p["u"], state0=wkv_state, out_state=wkv_out)
    B, T = x.shape[:2]
    y = y.reshape(B, T, cfg.d_model)
    y = nn.rmsnorm_apply(p["ln_out"], y, cfg.norm_eps) * g
    out = x + nn.linear_apply(p["wo"], y)
    return out, h[:, -1:], S


def channelmix_init(gen, cfg: ModelConfig, dtype, device=None):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln": nn.rmsnorm_init(d, dtype, device),
        "mu": torch.rand((2, d), generator=gen, dtype=torch.float32, device=device).to(dtype),
        "wk": nn.linear_init(gen, d, ff, dtype=dtype, device=device),
        "wv": nn.linear_init(gen, ff, d, dtype=dtype, device=device),
        "wr": nn.linear_init(gen, d, d, dtype=dtype, device=device),
    }


def channelmix_apply(p, cfg: ModelConfig, x, shift_state=None):
    """x: (B, T, D). Returns (out, new_shift_state)."""
    h = nn.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
    xx = _shift(h, shift_state)
    mu = p["mu"].to(x.dtype)
    xk = h + (xx - h) * mu[0]
    xr = h + (xx - h) * mu[1]
    k = torch.square(F.relu(nn.linear_apply(p["wk"], xk)))
    out = x + torch.sigmoid(nn.linear_apply(p["wr"], xr)) * nn.linear_apply(p["wv"], k)
    return out, h[:, -1:]


def rwkv_layer_init(gen, cfg: ModelConfig, dtype, device=None):
    return {"tm": timemix_init(gen, cfg, dtype, device),
            "cm": channelmix_init(gen, cfg, dtype, device)}


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = getattr(torch, cfg.param_dtype)
    embed = nn.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device)
    layers = stacked_init(cfg.num_layers, lambda: rwkv_layer_init(gen, cfg, dtype, device))
    return {
        "embed": embed,
        "layers": layers,  # leaves (L, ...)
        "ln_f": nn.rmsnorm_init(cfg.d_model, dtype, device),
        "head": nn.linear_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype, device=device),
    }


def rwkv_forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int -> logits (B, S, V).  K7 once a layer on the card."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], tokens).to(cdt)
    for lp in layer_params(params["layers"]):
        x, _, _ = timemix_apply(lp["tm"], cfg, x)
        x, _ = channelmix_apply(lp["cm"], cfg, x)
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)


# ----------------------------------------------------------------- decode
def rwkv_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    """Zero shift states ``(L, B, 1, D)`` in ``dtype`` and WKV states
    ``(L, B, H, K, K)`` in float32."""
    H, K = rwkv_dims(cfg)
    L, d = cfg.num_layers, cfg.d_model
    return {
        "tm_shift": torch.zeros((L, batch, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((L, batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, K, K), dtype=torch.float32, device=device),
    }


def rwkv_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                    device=None):
    """The decode state of `rwkv_state_init`: constant in the sequence
    length, so ``cache_len`` is ignored, and float32 whatever ``dtype`` is
    (the reference's `init_decode_cache` for the family)."""
    return rwkv_state_init(cfg, batch, device=device)


def rwkv_decode_step(params, cfg: ModelConfig, token, state, pos: int):
    """token: (B,) int; pos is unused (the recurrence carries position).
    Each time-mix layer runs the scan (K7 on the card) with T = 1 from its
    carried WKV state, which the scan overwrites with the new one.  Returns
    (logits (B, V), state); unlike the reference, which returns a new
    state, the state is written IN PLACE (and returned)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = nn.embed_apply(params["embed"], token[:, None]).to(cdt)  # (B, 1, D)
    tm, cm, wkv = state["tm_shift"], state["cm_shift"], state["wkv"]
    for i, lp in enumerate(layer_params(params["layers"])):
        x, tm_next, _ = timemix_apply(lp["tm"], cfg, x, tm[i].to(cdt), wkv[i], wkv_out=wkv[i])
        x, cm_next = channelmix_apply(lp["cm"], cfg, x, cm[i].to(cdt))
        tm[i].copy_(tm_next)
        cm[i].copy_(cm_next)
    x = nn.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    return nn.unembed_apply(params["head"], x)[:, 0], state
