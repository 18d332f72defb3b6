"""Minibatch-client SVRP — params, scan and driver.

Port of `repro.core.minibatch`.  Each round samples b clients without
replacement; each solves its prox subproblem from the same variance-reduced
target and the server averages:

    S_k ~ Uniform([M], b);   y_k^m ~= prox_{eta f_m}(x_k - eta g_k^m)
    x_{k+1} = (1/b) sum_{m in S_k} y_k^m;   w_{k+1} = x_{k+1} w.p. p else w_k

Communication: 2b per round (+ 3pM expected anchor refresh).  The round body
is `rounds.ROUND_DEFS["svrp_minibatch"]`; `svrp_minibatch_scan` binds it to
the registry prox solver over the lanes of its draws and
`run_svrp_minibatch` is the per-trial driver.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.rounds import ROUND_DEFS, make_registry_ops, scan_rounds
from repro_torch.core.types import RunResult, scalar_hparam
from repro_torch.device import problem_device


class MinibatchParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor
    p: torch.Tensor
    smoothness: torch.Tensor  # per-client L, used only by the "gd" local solver


def svrp_minibatch_scan(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    draws: Draws,
    hp: MinibatchParams,
    *,
    num_steps: int,
    batch_clients: int,
    prox_solver: str = "exact",
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    channel: str | None = None,
) -> RunResult:
    """SVRP with b = batch_clients sampled clients a round; the round's b
    subproblems are solved together, as lanes of the registry solver."""
    ops = make_registry_ops(
        "svrp_minibatch", problem, x0, x_star, hp, draws,
        prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol,
        batch_clients=batch_clients, channel=channel,
    )
    return scan_rounds(ROUND_DEFS["svrp_minibatch"], ops, x0, num_steps)


def run_svrp_minibatch(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    *,
    eta: float,
    p: float,
    batch_clients: int,
    num_steps: int,
    seed: int | None = None,
    draws: Draws | None = None,
    prox_solver: str = "exact",
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    smoothness: float | None = None,
    device=None,
) -> RunResult:
    """One minibatch-SVRP trajectory on ``device`` (default CUDA), with the
    cohorts and coins of ``draws`` (a per-trial record) or drawn from ``seed``."""
    if prox_solver == "gd" and smoothness is None:
        raise ValueError("prox_solver='gd' requires smoothness=L (Algorithm 7 stepsize)")
    dev = problem_device(problem, device)
    hp = MinibatchParams(eta=scalar_hparam(eta, dev), p=scalar_hparam(p, dev),
                         smoothness=scalar_hparam(smoothness or 0.0, dev))
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, p,
                        batch_clients=batch_clients, device=dev)
    return svrp_minibatch_scan(problem, x0, x_star, draws, hp, num_steps=num_steps,
                               batch_clients=batch_clients, prox_solver=prox_solver,
                               prox_steps=prox_steps, prox_tol=prox_tol)
