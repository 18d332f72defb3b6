"""Algorithm 2: Stochastic Variance-Reduced Proximal Point (SVRP): params, scan, driver.

Port of `repro.core.svrp`.  Loopless SVRG-style variance reduction inside the
prox argument:

    g_k      = grad f(w_k) - grad f_{m_k}(w_k)
    x_{k+1} ~= prox_{eta f_{m_k}}(x_k - eta g_k)
    w_{k+1}  = x_{k+1} w.p. p else w_k        (anchor refresh)

Theorem 2: with eta = mu/(2 delta^2), p = 1/M, the communication complexity is
O~((M + delta^2/mu^2) log 1/eps).  The round body is
`rounds.ROUND_DEFS["svrp"]`; `svrp_scan` binds it to the registry prox
solver over the lanes of its draws (one trial, or a sweep) and `run_svrp`
is the per-trial driver.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.rounds import ROUND_DEFS, make_registry_ops, scan_rounds
from repro_torch.core.types import RunResult, scalar_hparam
from repro_torch.device import problem_device


class SVRPParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor  # prox stepsize
    p: torch.Tensor  # anchor-refresh probability
    smoothness: torch.Tensor  # per-client L, used only by the "gd" local solver


def svrp_scan(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    draws: Draws,
    hp: SVRPParams,
    *,
    num_steps: int,
    prox_solver: str = "exact",
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    prox_factors=None,
    channel: str | None = None,
) -> RunResult:
    """One SVRP trajectory per lane of ``draws``: the initial anchor setup
    costs 3M, each round 2 plus a coin-gated 3M, and the full gradient is
    recomputed only on rounds where some lane refreshes.  ``prox_factors``
    passes the solver's hoisted state when the caller already holds it."""
    ops = make_registry_ops(
        "svrp", problem, x0, x_star, hp, draws,
        prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol,
        prox_factors=prox_factors, channel=channel,
    )
    return scan_rounds(ROUND_DEFS["svrp"], ops, x0, num_steps)


def run_svrp(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    *,
    eta: float,
    p: float,
    num_steps: int,
    seed: int | None = None,
    draws: Draws | None = None,
    prox_solver: str = "exact",
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    smoothness: float | None = None,
    device=None,
) -> RunResult:
    """One SVRP trajectory on ``device`` (default CUDA), with the clients and
    coins of ``draws`` (a per-trial record) or drawn from ``seed``."""
    if prox_solver == "gd" and smoothness is None:
        raise ValueError("prox_solver='gd' requires smoothness=L (Algorithm 7 stepsize)")
    dev = problem_device(problem, device)
    hp = SVRPParams(eta=scalar_hparam(eta, dev), p=scalar_hparam(p, dev),
                    smoothness=scalar_hparam(smoothness or 0.0, dev))
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, p, device=dev)
    return svrp_scan(problem, x0, x_star, draws, hp, num_steps=num_steps,
                     prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol)


def theorem2_stepsize(mu: float, delta: float) -> float:
    return mu / (2.0 * delta**2)


def theorem2_rate(mu: float, delta: float, M: int) -> float:
    """Per-iteration contraction factor tau = min(eta mu/(1+2 eta mu), p/2)."""
    eta = theorem2_stepsize(mu, delta)
    p = 1.0 / M
    return min(eta * mu / (1.0 + 2.0 * eta * mu), p / 2.0)


def theorem2_iterations(mu: float, delta: float, M: int, eps: float, r0_sq: float) -> float:
    """Iteration bound from the end of the Theorem 2 proof (eq. after (36))."""
    eta = theorem2_stepsize(mu, delta)
    pref = 1.0 + eta * mu * M
    return 2.0 * max(delta**2 / mu**2 + 1.0, M) * math.log(2.0 * r0_sq * pref / eps)
