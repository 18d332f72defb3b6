"""Kernel entry points the model and round code calls (the port of `repro.kernels.ops`).

The reference chooses between a chunked jnp path and its Pallas kernels with
a global `use_pallas` switch.  The port has no switch: the device decides.
A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version, inside each wrapper.

    attention(q, k, v, *, causal=True, sliding_window=None, q_offset=0)
        -> kernels.flash_attention.flash_attention  (K4), or, when an input
           needs a gradient, kernels.flash_attention.FlashAttention
           (K4 forward with its log-sum-exp, K4b backward)
    decode_attention(q, k_cache, v_cache, valid)
        -> kernels.decode_attention.decode_attention  (K5)
    ssm_scan(x, dt, A, B_mat, C_mat, D, state0=None)
        -> kernels.ssm_scan.ssm_scan  (K6), or, when an input needs a
           gradient, kernels.ssm_scan.SSMScan (K6 forward, K6b backward)
    rwkv6_scan(r, k, v, w, u, state0=None, *, out_state=None)
        -> kernels.rwkv6_scan.rwkv6_scan  (K7), or, when an input needs a
           gradient, kernels.rwkv6_scan.RWKV6Scan (K7 forward, K7b backward)
    prox_update(y, g, z, local_lr, inv_eta)
        -> kernels.prox_update.prox_update  (K3), one tensor
    prox_update_tree(y_tree, g_tree, z_tree, local_lr, inv_eta)
        -> kernels.prox_update.prox_update  (K3), one launch per dtype group

The model and round code look these names up here at call time, so a caller
that must run the plain versions on the card (chip_smoke.py's replays) can
rebind them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.kernels.prox_update import prox_update
from repro_torch.kernels import rwkv6_scan as _rwkv6
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels._build import needs_grad
from repro_torch.utils.tree import tree_leaves, tree_unflatten

__all__ = ["attention", "decode_attention", "prox_update", "prox_update_tree", "rwkv6_scan",
           "ssm_scan"]


def attention(q, k, v, *, causal=True, sliding_window=None, q_offset=0):
    """Attention over a full sequence; differentiable when an input needs a gradient."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, sliding_window, q_offset)
    return flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                           q_offset=q_offset)


def ssm_scan(x, dt, A, B_mat, C_mat, D, state0=None):
    """The Mamba-2 scan ``(y, state)``; differentiable when an input needs a gradient."""
    if needs_grad(x, dt, A, B_mat, C_mat, D, state0):
        return _ssm.SSMScan.apply(x, dt, A, B_mat, C_mat, D, state0)
    return _ssm.ssm_scan(x, dt, A, B_mat, C_mat, D, state0)


def rwkv6_scan(r, k, v, w, u, state0=None, *, out_state=None):
    """The WKV scan ``(y, state)``; differentiable when an input needs a
    gradient (then without ``out_state``: a state written in place has no
    gradient)."""
    if needs_grad(r, k, v, w, u, state0):
        if out_state is not None:
            raise ValueError("rwkv6_scan: out_state is written in place and cannot carry a "
                             "gradient; leave it out when an input needs one")
        return _rwkv6.RWKV6Scan.apply(r, k, v, w, u, state0)
    return _rwkv6.rwkv6_scan(r, k, v, w, u, state0, out_state=out_state)


def prox_update_tree(y_tree, g_tree, z_tree, local_lr, inv_eta):
    """The fused SVRP local step over a whole parameter tree.

    Every ``g`` leaf is rounded to its ``y`` leaf's dtype (gradients may
    arrive in float32 against bf16 parameters), and the leaves of each dtype
    go through K3 in one launch, read in place from a table of pointers: no
    concatenation and no split copy as in the reference."""
    ys = tree_leaves(y_tree)
    gs, zs = tree_leaves(g_tree), tree_leaves(z_tree)
    if not (len(ys) == len(gs) == len(zs)):
        raise ValueError(f"prox_update_tree: trees of {len(ys)}, {len(gs)}, {len(zs)} leaves")
    groups: dict[torch.dtype, list[int]] = {}
    for i, y in enumerate(ys):
        groups.setdefault(y.dtype, []).append(i)
    out = [None] * len(ys)
    for idxs in groups.values():
        upd = prox_update([ys[i] for i in idxs], [gs[i] for i in idxs], [zs[i] for i in idxs],
                          local_lr, inv_eta)
        for i, u in zip(idxs, upd):
            out[i] = u
    return tree_unflatten(y_tree, out)
