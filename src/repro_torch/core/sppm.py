"""Algorithm 1: Stochastic Proximal Point Method (SPPM) — params and Theorem 1.

Port of `repro.core.sppm`.  Theorem 1: with eta = mu*eps / (2 sigma_*^2) and
b <= (eps/4) (eta mu)^2/(1+eta mu)^2, SPPM reaches E||x_K - x_*||^2 <= eps in
    K = (1 + 2 sigma_*^2 / (mu^2 eps)) log(4 ||x0 - x_*||^2 / eps)
iterations, independent of L.  Each iteration costs 2 communication steps.
The round body is `rounds.ROUND_DEFS["sppm"]`; the per-trial `sppm_scan`
driver waits for the sequential substrate.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SPPMParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor
    smoothness: torch.Tensor  # per-client L, used only by the "gd" local solver


def theorem1_iterations(sigma_star_sq: float, mu: float, eps: float, r0_sq: float) -> float:
    """The iteration count K of Theorem 1 (eq. (3))."""
    return (1.0 + 2.0 * sigma_star_sq / (mu**2 * eps)) * math.log(4.0 * r0_sq / eps)


def theorem1_stepsize(sigma_star_sq: float, mu: float, eps: float) -> float:
    return mu * eps / (2.0 * sigma_star_sq)


def theorem1_prox_accuracy(eta: float, mu: float, eps: float) -> float:
    return eps / 4.0 * (eta * mu) ** 2 / (1.0 + eta * mu) ** 2
