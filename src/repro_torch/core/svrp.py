"""Algorithm 2: Stochastic Variance-Reduced Proximal Point (SVRP) — params and Theorem 2.

Port of `repro.core.svrp`.  Loopless SVRG-style variance reduction inside the
prox argument:

    g_k      = grad f(w_k) - grad f_{m_k}(w_k)
    x_{k+1} ~= prox_{eta f_{m_k}}(x_k - eta g_k)
    w_{k+1}  = x_{k+1} w.p. p else w_k        (anchor refresh)

Theorem 2: with eta = mu/(2 delta^2), p = 1/M, the communication complexity is
O~((M + delta^2/mu^2) log 1/eps).  The round body is
`rounds.ROUND_DEFS["svrp"]`; the per-trial `svrp_scan` driver waits for the
sequential substrate.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SVRPParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor  # prox stepsize
    p: torch.Tensor  # anchor-refresh probability
    smoothness: torch.Tensor  # per-client L, used only by the "gd" local solver


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
