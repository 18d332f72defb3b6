"""Optimizers and schedules: the port of `repro.optim.optimizers`.

AdamW keeps its moments in float32 whatever the parameter dtype, as the
reference does (`torch.optim.AdamW` keeps bf16 moments for bf16 parameters
and decays the weights in another order, so it is not used).  The
numerics are the reference's, operation by operation: ``t = step`` in
float32, the bias corrections ``1 - b**t`` in float32, then

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p
    p = (p - lr delta).to(p.dtype)

all in float32.  Unlike the reference, which returns new trees, the updates
write into the moment and parameter tensors they are given, leaf by leaf,
and return those same tensors: at Qwen2-1.5B's size the moments alone take
14.2 GB, and a second copy of them would double that.

Every division here divides by a tensor on the operand's device: PyTorch's
CUDA division by a host scalar multiplies by its reciprocal instead, which
rounds differently from the reference's division.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_sqnorm

PyTree = Any


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class OptState(NamedTuple):
    step: int
    mu: PyTree  # first moment (float32)
    nu: PyTree  # second moment (float32)


def adamw_init(params: PyTree) -> OptState:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=0, mu=tree_map(f32, params), nu=tree_map(f32, params))


def adamw_update(grads: PyTree, state: OptState, params: PyTree, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[PyTree, OptState]:
    """One AdamW step, IN PLACE: every leaf of ``params``, ``state.mu`` and
    ``state.nu`` is overwritten.  Returns ``(params, OptState(step + 1, mu,
    nu))`` holding those same tensors."""
    step = state.step + 1
    t = _f32(step)
    bc1, bc2 = 1.0 - _f32(b1) ** t, 1.0 - _f32(b2) ** t  # float32, on the host
    on = {}  # the corrections on each leaf's device, copied once

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                          tree_leaves(params)):
        if p.device not in on:
            on[p.device] = (bc1.to(p.device), bc2.to(p.device))
        c1, c2 = on[p.device]
        g32 = g.float()
        m.mul_(b1).add_(g32 * (1.0 - b1))
        v.mul_(b2).add_(g32 * (1.0 - b2) * g32)
        del g32
        p32 = p.float()
        delta = (m / c1).div_(torch.sqrt(v / c2).add_(eps)).add_(p32 * weight_decay)
        p.copy_(p32 - delta.mul_(lr))
    return params, OptState(step=step, mu=state.mu, nu=state.nu)


class SGDMState(NamedTuple):
    step: int
    momentum: PyTree  # float32


def sgdm_init(params: PyTree) -> SGDMState:
    return SGDMState(step=0, momentum=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def sgdm_update(grads: PyTree, state: SGDMState, params: PyTree, *, lr: float = 1e-2,
                beta: float = 0.9) -> tuple[PyTree, SGDMState]:
    """One heavy-ball step ``m = beta m + g; p = p - lr m`` in float32, IN
    PLACE as `adamw_update`."""
    for g, m, p in zip(tree_leaves(grads), tree_leaves(state.momentum), tree_leaves(params)):
        m.mul_(beta).add_(g.float())
        p.copy_(p.float() - m * lr)
    return params, SGDMState(step=state.step + 1, momentum=state.momentum)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """``(grads * min(1, max_norm / max(norm, 1e-12)), norm)``: a new tree,
    each leaf scaled in its own dtype; ``norm`` is the global L2 norm in
    `tree_sqnorm`'s dtype (bfloat16 for an all-bf16 tree, as in the
    reference), and so is the scale."""
    norm = torch.sqrt(tree_sqnorm(grads))
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-12),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def cosine_schedule(step, *, base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a 0-d
    float32 tensor: cosine from ``base_lr`` down to ``final_frac base_lr``
    over ``total_steps``, flat after."""
    s = _f32(step)
    frac = torch.clamp(s / _f32(total_steps, s.device), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return base_lr * (final_frac + (1.0 - final_frac) * cos)


def linear_warmup_cosine(step, *, base_lr: float, warmup: int,
                         total_steps: int) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then `cosine_schedule` over the
    remaining ``total_steps - warmup``; a 0-d float32 tensor."""
    s = _f32(step)
    warm = base_lr * s / _f32(max(warmup, 1), s.device)
    decay = cosine_schedule(torch.as_tensor(step) - warmup, base_lr=base_lr,
                            total_steps=max(total_steps - warmup, 1))
    return torch.where(s < warmup, warm, decay)
