"""Step functions on one card: the port of `repro.launch.steps`.

The reference lowers each step onto a device mesh with parameter, batch and
cache shardings; on one H100 the mesh and the shardings are dropped and the
maths is the same:

    step, helpers = make_svrp_train_step(cfg, svrp, cohorts=C)
    state = helpers["init_state"]()             # SVRPServerState: bf16 x, w; float32 gbar
    state, metrics = step(state, batch)         # one DeepSVRP round over C cohorts
    step, helpers = make_adamw_train_step(cfg)  # the "ordinary distributed SGD" baseline
    state = helpers["init_state"]()             # AdamWTrainState: params, float32 moments
    state, metrics = step(state, batch)         # {"loss", "grad_norm"}; state updated in place
    prefill = make_prefill_step(cfg)            # (params, {"tokens": (B, S)}) -> (B, V)
    serve = make_serve_step(cfg)                # (params, cache, token, pos) -> (logits, cache)

The prefill and serve steps take a parameter tree or its int8 form
(`repro_torch.quant.quantize_params`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.deep import DeepSVRPConfig, draw_refresh, grad_of
from repro_torch.core.rounds import local_prox_gd_tree
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import OptState, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.utils.tree import tree_map, value_and_grad

PyTree = Any


class SVRPServerState(NamedTuple):
    """The server's state: x and w in the parameter dtype, gbar in float32."""

    params: PyTree
    anchor: PyTree
    anchor_grad: PyTree
    step: int
    rng: torch.Generator  # the refresh coins of a native run (host)


def _check_trainable(cfg: ModelConfig) -> None:
    """Raise unless ``cfg``'s family is ported (`models.model`)."""
    M._family(cfg)


def _device_batch(batch, dev) -> dict:
    return {k: torch.as_tensor(batch[k], device=dev).long() for k in ("tokens", "labels")}


def _accumulate(acc, tree):
    """``acc + tree`` in float32, leaf by leaf, into ``acc`` (None: a new sum)."""
    if acc is None:  # a copy: a float32 leaf of ``tree`` may be a leaf of x (K = 0)
        return tree_map(lambda t: t.to(torch.float32, copy=True), tree)
    tree_map(lambda a, t: a.add_(t.float()), acc, tree)
    return acc


def make_svrp_train_step(cfg: ModelConfig, svrp: DeepSVRPConfig, *, cohorts: int = 1,
                         device=None):
    """The DeepSVRP round as a train step on one card: ``(step, helpers)``.

    ``step(state, batch, refresh=None) -> (state, {"loss": ...})``.  The
    reference's mesh axis of client cohorts becomes ``cohorts`` cohorts run
    in turn: the batch's leading axis is cohort-major, as `ShardedBatcher`
    lays it out, and its rows ``[c*b:(c+1)*b]`` are cohort c's.  A round:

    * for each cohort: ``loss_at_w, g_anchor = value_and_grad(w)``; ``z = x
      - (eta (gbar - g_anchor)).to(x.dtype)`` (float32 inside); K local steps
      through `local_prox_gd_tree` (K3); ``y`` added into a float32 sum;
    * ``x' = (sum / C).to(x.dtype)`` (the reference's `pmean_f32`);
    * on a refresh round: ``w = x'`` and ``gbar`` = the float32 cohort mean of
      the gradients at x' ("exact") or at each cohort's y_{K-1}
      ("reuse_local").

    The coin is ``refresh`` when given (tests inject the reference's), else a
    draw from ``state.rng``; it is drawn before the round, so a plain round
    skips the refresh gradients the reference computes and discards.  The
    reported loss is the cohort mean of ``loss_at_w``.  C (1 + K) forward and
    backward passes a round, plus C on an "exact" refresh round; every pass
    runs attention through K4 and K4b (``ops.attention``), the Mamba-2 scans
    of the hybrid family through K6 and K6b (``ops.ssm_scan``), the WKV scans
    of the ssm family through K7 and K7b (``ops.rwkv6_scan``).
    """
    _check_trainable(cfg)
    dev = resolve_device(device)
    if cohorts < 1:
        raise ValueError(f"cohorts must be >= 1, got {cohorts}")
    if svrp.refresh_grad_mode not in ("exact", "reuse_local"):
        raise ValueError(f"unknown refresh_grad_mode {svrp.refresh_grad_mode!r}")

    def loss(params, batch):
        return M.loss_fn(params, cfg, batch)

    def split(batch):
        batch = _device_batch(batch, dev)
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.shape[0] % cohorts:
            raise ValueError(f"batch of {tokens.shape[0]} rows does not split over "
                             f"{cohorts} cohorts")
        b = tokens.shape[0] // cohorts
        return [{"tokens": tokens[c * b:(c + 1) * b], "labels": labels[c * b:(c + 1) * b]}
                for c in range(cohorts)]

    def step(state: SVRPServerState, batch, *, refresh: bool | None = None):
        shards = split(batch)
        if refresh is None:
            refresh = draw_refresh(state.rng, svrp.anchor_prob)
        reuse = svrp.refresh_grad_mode == "reuse_local"
        x, w, gbar = state.params, state.anchor, state.anchor_grad
        y_sum = g_sum = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for shard in shards:
            loss_at_w, g_anchor = value_and_grad(loss, w, shard)
            loss_sum += loss_at_w.float()
            z = tree_map(lambda xx, gb, ga: xx - (svrp.eta * (gb - ga.to(gb.dtype))).to(xx.dtype),
                         x, gbar, g_anchor)
            # only K = 0 returns g0; holding it through the loop costs a gradient tree
            g0 = g_anchor if svrp.local_steps == 0 else None
            del g_anchor
            y, g_last = local_prox_gd_tree(grad_of(loss, shard), z, x, svrp.local_lr,
                                           1.0 / svrp.eta, svrp.local_steps, g0=g0)
            del z, g0
            y_sum = _accumulate(y_sum, y)
            if refresh and reuse:
                g_sum = _accumulate(g_sum, g_last)
            del y, g_last
        x_next = tree_map(lambda s, xx: (s / cohorts).to(xx.dtype), y_sum, x)
        del y_sum
        if refresh:
            if not reuse:
                for shard in shards:
                    g_sum = _accumulate(g_sum, grad_of(loss, shard)(x_next))
            anchor_next, anchor_grad_next = x_next, tree_map(lambda s: s / cohorts, g_sum)
        else:
            anchor_next, anchor_grad_next = w, gbar
        new_state = SVRPServerState(params=x_next, anchor=anchor_next,
                                    anchor_grad=anchor_grad_next, step=state.step + 1,
                                    rng=state.rng)
        return new_state, {"loss": loss_sum / cohorts}

    def init_state(generator: torch.Generator | None = None) -> SVRPServerState:
        """Weights from ``generator`` (default seed 0 on the card), gbar zeros
        in float32 (the reference's `init_state`), coins from seed 0."""
        params = M.init_params(cfg, generator, device=dev)
        gbar = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
        return SVRPServerState(params=params, anchor=params, anchor_grad=gbar, step=0,
                               rng=torch.Generator().manual_seed(0))

    return step, {"init_state": init_state}


class AdamWTrainState(NamedTuple):
    params: PyTree
    opt: OptState


def make_adamw_train_step(cfg: ModelConfig, *, lr: float = 3e-4, clip: float = 1.0,
                          device=None):
    """The AdamW baseline on one card: ``(step, helpers)``.

    ``step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    ``value_and_grad`` of the model's loss over the whole batch (the
    reference's data axis collapses on one card), `clip_by_global_norm` to
    ``clip``, then `adamw_update` at ``lr``, which writes the new parameters
    and moments into ``state``'s tensors.  One forward and one backward pass
    a step: attention through K4 and K4b, the Mamba-2 scans through K6 and
    K6b, the WKV scans through K7 and K7b.
    ``helpers["init_state"](generator=None)`` gives the weights from
    ``generator`` (default seed 0 on the card) and zero moments."""
    _check_trainable(cfg)
    dev = resolve_device(device)

    def step(state: AdamWTrainState, batch):
        loss, grads = value_and_grad(lambda p, b: M.loss_fn(p, cfg, b), state.params,
                                     _device_batch(batch, dev))
        grads, gnorm = clip_by_global_norm(grads, clip)
        params, opt = adamw_update(grads, state.opt, state.params, lr=lr)
        return AdamWTrainState(params, opt), {"loss": loss, "grad_norm": gnorm}

    def init_state(generator: torch.Generator | None = None) -> AdamWTrainState:
        params = M.init_params(cfg, generator, device=dev)
        return AdamWTrainState(params, adamw_init(params))

    return step, {"init_state": init_state}


def make_prefill_step(cfg: ModelConfig, *, device=None):
    """Full-sequence forward: flash attention (K4) at every attention layer
    or site of the dense and hybrid families, the Mamba-2 scan (K6) in every
    Mamba-2 layer of the hybrid family, the WKV scan (K7) in every time-mix
    layer of the ssm family; the step returns the last position's logits
    (B, V)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params, batch):
        logits, _ = M.forward(params, cfg, {"tokens": torch.as_tensor(batch["tokens"], device=dev)})
        return logits[:, -1].clone()  # a view would keep all B x S x V logits alive

    return step


def make_serve_step(cfg: ModelConfig, *, device=None):
    """One-token decode: decode attention (K5) at every attention layer or
    site of the dense and hybrid families, the WKV scan (K7) with T = 1 in
    every time-mix layer of the ssm family:
    (params, cache, token (B,), pos) -> (logits (B, V), cache updated in place)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(params, cache, token, pos):
        return M.decode_step(params, cfg, torch.as_tensor(token, device=dev), cache, pos)

    return step
