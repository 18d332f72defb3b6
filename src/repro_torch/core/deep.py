"""DeepSVRP: the paper's SVRP on parameter trees (the port of `repro.core.deep`).

Each cohort is one client; a round is

  1. control variate     g^m = gbar - grad f_m(w)
  2. prox target         z^m = x - eta g^m
  3. K prox-GD steps     y <- y - beta (grad f_m(y) + (y - z^m)/eta)   (Algorithm 7)
  4. aggregate           x' = mean_m y^m
  5. anchor refresh      w.p. p:  w <- x', gbar <- mean_m grad f_m(w)

This module holds the single-process form: one cohort, so the reference's
`_maybe_pmean` over no mesh axes is the identity.  The train step of one
card (`launch.steps.make_svrp_train_step`) runs several cohorts in turn.
`deep_svrp_scan` and `run_deep_svrp` are the flat-vector form the engine
sweeps (`run_batch("deep_svrp", ...)`): every client a cohort, all of them
each round, over a convex problem or `problems.fed_lm.FedLMProblem`.

The refresh coin is injected.  The reference flips it from
``fold_in(rng, step)``, which torch cannot replay; here a round takes
``refresh=`` (tests pass the reference's coins) or, when it is None, draws
it from the state's ``torch.Generator`` on the host, so the round never
waits on the device to decide.  The gradient at the new anchor is taken only
on a refresh round; the reference takes it every round and keeps it only
then, so the state that comes out is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.rounds import ROUND_DEFS, local_prox_gd_tree, make_registry_ops, scan_rounds
from repro_torch.core.types import RunResult, scalar_hparam
from repro_torch.device import problem_device
from repro_torch.utils.tree import (
    tree_add,
    tree_axpy,
    tree_scale,
    tree_sub,
    tree_zeros_like,
    value_and_grad,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DeepSVRPConfig:
    eta: float = 0.5  # server prox stepsize (theory: mu/(2 delta^2))
    local_lr: float = 0.05  # Algorithm 7's beta
    local_steps: int = 4  # K inner prox-GD steps per round
    anchor_prob: float = 0.1  # p, the Bernoulli anchor-refresh probability
    # "exact": the refreshed anchor gradient is taken at the aggregated x'
    # (paper-faithful).  "reuse_local": each cohort's last local gradient,
    # at y_{K-1}, stands in for it (one gradient pass fewer).
    refresh_grad_mode: str = "exact"


class DeepSVRPState(NamedTuple):
    params: PyTree  # x_k, the server iterate
    anchor: PyTree  # w_k
    anchor_grad: PyTree  # gbar = grad f(w_k), cohort-averaged at refresh
    step: int
    rng: torch.Generator  # the refresh coins of a native run


def draw_refresh(rng: torch.Generator, anchor_prob: float) -> bool:
    """One Bernoulli(anchor_prob) coin from a host generator."""
    return bool(torch.rand((), generator=rng).item() < anchor_prob)


def grad_of(loss_fn: Callable, batch) -> Callable:
    """``params -> grads`` of ``loss_fn(params, batch)``."""
    return lambda params: value_and_grad(loss_fn, params, batch)[1]


def deep_svrp_init(params: PyTree, grad0: PyTree, rng: torch.Generator | None = None):
    """grad0 should be the cohort-averaged gradient at params."""
    rng = rng if rng is not None else torch.Generator().manual_seed(0)
    return DeepSVRPState(params=params, anchor=params, anchor_grad=grad0, step=0, rng=rng)


def deep_svrp_round(loss_fn: Callable[[PyTree, Any], torch.Tensor], state: DeepSVRPState,
                    batch: Any, cfg: DeepSVRPConfig, *, refresh: bool | None = None):
    """One SVRP round.  ``loss_fn(params, batch)`` is the cohort's loss.
    Returns ``(new_state, loss at x)``."""
    grad_fn = grad_of(loss_fn, batch)

    # (1) control variate from the anchor; (2) prox target z = x - eta g_k
    g_k = tree_sub(state.anchor_grad, grad_fn(state.anchor))
    z = tree_axpy(-cfg.eta, g_k, state.params)
    del g_k
    # (3) K local prox-GD steps (Algorithm 7), K3 on the card
    x_next, _ = local_prox_gd_tree(grad_fn, z, state.params, cfg.local_lr, 1.0 / cfg.eta,
                                   cfg.local_steps)
    # (4) one cohort: the mean is the identity; (5) the anchor refresh
    if refresh is None:
        refresh = draw_refresh(state.rng, cfg.anchor_prob)
    anchor_next = x_next if refresh else state.anchor
    anchor_grad_next = grad_fn(anchor_next) if refresh else state.anchor_grad
    with torch.no_grad():
        loss_val = loss_fn(state.params, batch)
    new_state = DeepSVRPState(params=x_next, anchor=anchor_next, anchor_grad=anchor_grad_next,
                              step=state.step + 1, rng=state.rng)
    return new_state, loss_val


class DeepSVRPScanParams(NamedTuple):
    """Per-trial hyperparameters of the convex DeepSVRP scan, each a (B,)
    tensor in a sweep."""

    eta: torch.Tensor  # server prox stepsize
    local_lr: torch.Tensor  # Algorithm 7's beta
    anchor_prob: torch.Tensor  # p, the Bernoulli anchor-refresh probability


def deep_svrp_scan(problem, x0: torch.Tensor, x_star: torch.Tensor, draws: Draws,
                   hp: DeepSVRPScanParams, *, num_steps: int, local_steps: int = 4,
                   channel: str | None = None) -> RunResult:
    """DeepSVRP's full-participation schedule on a flat-vector problem (a
    convex one, or `problems.fed_lm.FedLMProblem`), one trajectory per lane
    of ``draws``, whose coins are the only draws:

      1. per-client control variate  g^m = gbar - grad f_m(w)
      2. prox target                 z^m = x - eta g^m
      3. K prox-GD steps             y <- y - beta (grad f_m(y) + (y - z^m)/eta)
      4. aggregate                   x' = mean_m y^m
      5. anchor refresh w.p. p       w <- x', gbar <- grad f(w)

    comm: 3M to set up the anchor, then 2M a round plus a coin-gated 2M.
    The round is `rounds.ROUND_DEFS["deep_svrp"]` and its local solver the
    binding every substrate shares (`rounds.deep_local_prox_gd`, one K1
    launch a GD step)."""
    ops = make_registry_ops("deep_svrp", problem, x0, x_star, hp, draws,
                            local_steps=local_steps, channel=channel)
    return scan_rounds(ROUND_DEFS["deep_svrp"], ops, x0, num_steps)


def run_deep_svrp(problem, x0: torch.Tensor, x_star: torch.Tensor, *, eta: float,
                  local_lr: float, anchor_prob: float, num_steps: int, seed: int | None = None,
                  draws: Draws | None = None, local_steps: int = 4, device=None) -> RunResult:
    """One DeepSVRP trajectory on ``device`` (default CUDA), with the coins of
    ``draws`` (a per-trial coins-only record) or drawn from ``seed``."""
    dev = problem_device(problem, device)
    hp = DeepSVRPScanParams(eta=scalar_hparam(eta, dev), local_lr=scalar_hparam(local_lr, dev),
                            anchor_prob=scalar_hparam(anchor_prob, dev))
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, anchor_prob,
                        clients=False, device=dev)
    return deep_svrp_scan(problem, x0, x_star, draws, hp, num_steps=num_steps,
                          local_steps=local_steps)


# ----------------------------------------------------------------- baselines
class FedAvgState(NamedTuple):
    params: PyTree
    step: int


def fedavg_round(loss_fn, state: FedAvgState, batch, *, local_lr: float, local_steps: int):
    """FedAvg / Local-SGD: K local SGD steps then the (one-cohort) average."""
    grad_fn = grad_of(loss_fn, batch)
    y = state.params
    for _ in range(local_steps):
        y = tree_axpy(-local_lr, grad_fn(y), y)
    with torch.no_grad():
        loss_val = loss_fn(state.params, batch)
    return FedAvgState(params=y, step=state.step + 1), loss_val


class DeepScaffoldState(NamedTuple):
    params: PyTree
    c_local: PyTree  # this cohort's control variate
    c_global: PyTree  # server control variate (cohort-average of c_local)
    step: int


def deep_scaffold_init(params: PyTree) -> DeepScaffoldState:
    return DeepScaffoldState(params=params, c_local=tree_zeros_like(params),
                             c_global=tree_zeros_like(params), step=0)


def deep_scaffold_round(loss_fn, state: DeepScaffoldState, batch, *, local_lr: float,
                        local_steps: int):
    """SCAFFOLD with full cohort participation (Option II control variates)."""
    grad_fn = grad_of(loss_fn, batch)
    corr = tree_sub(state.c_global, state.c_local)
    y = state.params
    for _ in range(local_steps):
        y = tree_axpy(-local_lr, tree_add(grad_fn(y), corr), y)
    # c_m^+ = c_m - c + (x - y) / (K lr)
    drift = tree_scale(tree_sub(state.params, y), 1.0 / (local_steps * local_lr))
    c_local_next = tree_add(tree_sub(state.c_local, state.c_global), drift)
    with torch.no_grad():
        loss_val = loss_fn(state.params, batch)
    return DeepScaffoldState(y, c_local_next, c_local_next, state.step + 1), loss_val
