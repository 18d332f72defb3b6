"""Algorithm 1: Stochastic Proximal Point Method (SPPM): params, scan, driver.

Port of `repro.core.sppm`.  Theorem 1: with eta = mu*eps / (2 sigma_*^2) and
b <= (eps/4) (eta mu)^2/(1+eta mu)^2, SPPM reaches E||x_K - x_*||^2 <= eps in
    K = (1 + 2 sigma_*^2 / (mu^2 eps)) log(4 ||x0 - x_*||^2 / eps)
iterations, independent of L.  Each iteration costs 2 communication steps.
The round body is `rounds.ROUND_DEFS["sppm"]`; `sppm_scan` binds it to the
registry prox solver over the lanes of its draws (one trial, or a sweep) and
`run_sppm` is the per-trial driver.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.rounds import ROUND_DEFS, make_registry_ops, scan_rounds
from repro_torch.core.types import RunResult, scalar_hparam
from repro_torch.device import problem_device


class SPPMParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor
    smoothness: torch.Tensor  # per-client L, used only by the "gd" local solver


def sppm_scan(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    draws: Draws,
    hp: SPPMParams,
    *,
    num_steps: int,
    prox_solver: str = "exact",  # registry name: exact/spectral/gd/newton/newton-cg
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    channel: str | None = None,
) -> RunResult:
    ops = make_registry_ops(
        "sppm", problem, x0, x_star, hp, draws,
        prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol, channel=channel,
    )
    return scan_rounds(ROUND_DEFS["sppm"], ops, x0, num_steps)


def run_sppm(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    *,
    eta: float,
    num_steps: int,
    seed: int | None = None,
    draws: Draws | None = None,
    prox_solver: str = "exact",
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    smoothness: float | None = None,
    device=None,
) -> RunResult:
    """One SPPM trajectory on ``device`` (default CUDA), with the clients of
    ``draws`` (a per-trial record) or drawn from ``seed``."""
    if prox_solver == "gd" and smoothness is None:
        raise ValueError("prox_solver='gd' requires smoothness=L (Algorithm 7 stepsize)")
    dev = problem_device(problem, device)
    hp = SPPMParams(eta=scalar_hparam(eta, dev),
                    smoothness=scalar_hparam(smoothness or 0.0, dev))
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, device=dev)
    return sppm_scan(problem, x0, x_star, draws, hp, num_steps=num_steps,
                     prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol)


def theorem1_iterations(sigma_star_sq: float, mu: float, eps: float, r0_sq: float) -> float:
    """The iteration count K of Theorem 1 (eq. (3))."""
    return (1.0 + 2.0 * sigma_star_sq / (mu**2 * eps)) * math.log(4.0 * r0_sq / eps)


def theorem1_stepsize(sigma_star_sq: float, mu: float, eps: float) -> float:
    return mu * eps / (2.0 * sigma_star_sq)


def theorem1_prox_accuracy(eta: float, mu: float, eps: float) -> float:
    return eps / 4.0 * (eta * mu) ** 2 / (1.0 + eta * mu) ** 2
