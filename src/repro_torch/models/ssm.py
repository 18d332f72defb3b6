"""Mamba-2 blocks (zamba2's backbone): the port of `repro.models.ssm`.

Selective state space with a scalar decay per head, a causal depthwise conv
on (x, B, C), a gated output.  The full-sequence scan goes through
`kernels.ops.ssm_scan` (K6 on the card, its plain chunked version on the
CPU); this module is the projections, the conv, the gating and the
decode-time one-step recurrence, which stays plain PyTorch as the reference
leaves it to XLA.

Precision follows the reference: the full-sequence conv runs in the compute
dtype, the decode conv in float32 against a float32 conv state; dt, A, D
and the SSM state are float32.  Sharding annotations (no-ops on one card)
are not carried.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as nn


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_num_heads or d_inner // cfg.ssm_head_dim
    P = d_inner // H
    N = cfg.ssm_state_dim
    return d_inner, H, P, N


def mamba_init(gen, cfg: ModelConfig, dtype, device=None):
    """One layer's parameters, drawn as the reference draws them (in_proj and
    out_proj normal * d_in**-0.5, conv_w normal * 0.1, dt_bias uniform in
    [-4, -1)); A_log, D and dt_bias are float32 whatever ``dtype`` is."""
    d = cfg.d_model
    d_inner, H, P, N = mamba_dims(cfg)
    conv_ch = d_inner + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": nn.rmsnorm_init(d, dtype, device),
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "in_proj": nn.linear_init(gen, d, 2 * d_inner + 2 * N + H, dtype=dtype, device=device),
        "conv_w": nn._normal(gen, (cfg.ssm_conv_width, conv_ch), 0.1, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.rand((H,), generator=gen, **f32) * 3.0 - 4.0,
        "out_norm": nn.rmsnorm_init(d_inner, dtype, device),
        "out_proj": nn.linear_init(gen, d_inner, d, dtype=dtype, device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    """(z, x, B, C, dt): views into the in_proj output's last axis."""
    d_inner, H, P, N = mamba_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(x, w, b):
    """x: (B, T, C); depthwise causal conv of width W = w.shape[0], in x's dtype."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:T] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def mamba_apply(p, cfg: ModelConfig, x):
    """x: (B, T, D) -> (B, T, D). Full sequence (prefill): K6 on the card.

    x, B and C reach the scan as column views of the conv output (K6 reads
    them through their strides; nothing is copied)."""
    B, T, _ = x.shape
    d_inner, H, P, N = mamba_dims(cfg)
    h = nn.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
    z, xc, B_mat, C_mat, dt = _split_proj(cfg, nn.linear_apply(p["in_proj"], h))

    conv_in = torch.cat([xc, B_mat, C_mat], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xc, B_mat, C_mat = torch.split(conv_out, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = kops.ssm_scan(xc.view(B, T, H, P), dt, A, B_mat, C_mat, p["D"])
    y = y.reshape(B, T, d_inner)
    y = nn.rmsnorm_apply(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    return x + nn.linear_apply(p["out_proj"], y)


# ----------------------------------------------------------------- decode
def mamba_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    d_inner, H, P, N = mamba_dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }


def mamba_decode_step(p, cfg: ModelConfig, x, state):
    """x: (B, 1, D); the constant-memory one-token step.

    Returns ``(out, state)``; unlike the reference, which returns a new
    state, ``state["conv"]`` and ``state["ssm"]`` are written IN PLACE (and
    returned)."""
    B = x.shape[0]
    d_inner, H, P, N = mamba_dims(cfg)
    f32 = torch.float32
    h = nn.rmsnorm_apply(p["ln"], x, cfg.norm_eps)
    z, xc, B_mat, C_mat, dt = _split_proj(cfg, nn.linear_apply(p["in_proj"], h))

    conv_in = torch.cat([xc, B_mat, C_mat], dim=-1)  # (B, 1, C)
    # the reference's concatenation promotes to the float32 state's dtype
    window = torch.cat([state["conv"].to(f32), conv_in.to(f32)], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(f32))
    conv_out = F.silu(conv_out + p["conv_b"].to(f32))[:, None, :].to(x.dtype)
    xc, B_mat, C_mat = torch.split(conv_out, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, 1, H)
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B, H, P).to(f32)
    decay = torch.exp(A[None] * dt[:, 0])  # (B, H)
    upd = (dt[:, 0, :, None] * xh)[..., None] * B_mat[:, 0].to(f32)[:, None, None, :]
    ssm_next = decay[..., None, None] * state["ssm"] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm_next, C_mat[:, 0].to(f32))
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = nn.rmsnorm_apply(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out = x + nn.linear_apply(p["out_proj"], y)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(ssm_next)
    return out, state
