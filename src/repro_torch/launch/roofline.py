"""Analytic compute / memory cost of a transformer forward pass.

Port of the part of `repro.launch.roofline` that the FLOPs accounting
(`core.flops`, the federated LM's client gradient) needs: `_fwd_cost`, over
the port's `configs.base.ModelConfig`.  The dry-run roofline (`analyze`,
`analytic_cost`, `model_flops`) belongs to the pod launch layer (ROADMAP §1
item 12) and is not ported yet.
"""
from __future__ import annotations


def _fwd_cost(cfg, tokens: float, batch: float, seq_q: float, ctx_avg: float) -> tuple[float, float, dict]:
    """One forward pass: (flops, hbm_bytes, detail).

    matmul flops = 2 * N_mm * tokens, N_mm = active params minus the embedding
    table (a gather, not a matmul; the lm head IS counted).
    attention flops per layer = 4 * batch * H * seq_q * ctx_avg * head_dim
    (QK^T and PV, multiply+add).  scan families add their recurrence flops.
    HBM bytes = weight traffic (active weights read once per pass) +
    activation traffic (c_act * tokens * d_model * L * dtype; c_act ~= 12
    covers x, q/k/v, attn out, gate/up/down intermediates) + logits.
    """
    dt = 2 if cfg.compute_dtype == "bfloat16" else 4
    pdt = 2 if cfg.param_dtype == "bfloat16" else 4
    n_active = cfg.active_param_count()
    n_mm = max(n_active - cfg.vocab_size * cfg.d_model, 0)
    mm_flops = 2.0 * n_mm * tokens

    attn_flops = 0.0
    L_attn = 0
    if cfg.family in ("dense", "moe", "vlm"):
        L_attn = cfg.num_layers
    elif cfg.family == "hybrid":
        L_attn = cfg.num_layers // cfg.attn_every
    elif cfg.family == "audio":
        # encoder self (F x F) + decoder self + cross handled by caller via
        # ctx_avg on the decoder; encoder added here:
        F = max(int(seq_q) // 4, 16) if seq_q > 1 else cfg.frontend_len
        attn_flops += 4.0 * batch * cfg.num_heads * F * F * cfg.head_dim * cfg.encoder_layers
        L_attn = 2 * cfg.num_layers  # self + cross
    attn_flops += 4.0 * batch * cfg.num_heads * seq_q * ctx_avg * cfg.head_dim * L_attn

    scan_flops = 0.0
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        n_mamba = cfg.num_layers - cfg.num_layers // cfg.attn_every
        scan_flops = 6.0 * tokens * d_inner * cfg.ssm_state_dim * n_mamba
    elif cfg.family == "ssm":  # rwkv6
        K = cfg.head_dim
        scan_flops = 4.0 * tokens * cfg.d_model * K * cfg.num_layers

    flops = mm_flops + attn_flops + scan_flops

    weight_bytes = n_active * pdt
    act_bytes = 12.0 * tokens * cfg.d_model * (cfg.num_layers + (cfg.encoder_layers or 0)) * dt
    logits_bytes = tokens * cfg.vocab_size * dt
    hbm = weight_bytes + act_bytes + logits_bytes
    return flops, hbm, {
        "mm_flops": mm_flops,
        "attn_flops": attn_flops,
        "scan_flops": scan_flops,
        "weight_bytes": weight_bytes,
        "act_bytes": act_bytes,
        "logits_bytes": logits_bytes,
    }
