"""Algorithm 3: Catalyst acceleration wrapped around SVRP (Catalyzed SVRP).

Port of `repro.core.catalyst` (params, recurrence and Theorem-3 helpers).
Each outer step t approximately minimizes

    h_t(x) = f(x) + gamma/2 ||x - y_{t-1}||^2

with SVRP as the inner solver, then extrapolates.  Theorem 3: gamma =
delta/sqrt(M) - mu when delta/mu >= sqrt(M), else 0.  The fused sweep runs
the outer recurrence in `rounds._catalyzed_batched_scan`; the per-trial
nested-scan driver waits for the sequential substrate.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CatalyzedSVRPParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    mu: torch.Tensor
    gamma: torch.Tensor  # Catalyst smoothing; 0 disables acceleration (case b)
    eta: torch.Tensor  # inner SVRP stepsize
    p: torch.Tensor  # inner anchor-refresh probability
    smoothness: torch.Tensor  # used only by the "gd" inner prox solver


def catalyst_extrapolate(alpha_prev, q):
    """The Catalyst momentum recurrence: alpha_t solves
    alpha^2 = (1 - alpha) alpha_{t-1}^2 + q alpha, and beta_t is the
    extrapolation weight  y_t = x_t + beta_t (x_t - x_{t-1})."""
    ap2 = alpha_prev**2
    alpha_t = 0.5 * ((q - ap2) + torch.sqrt((q - ap2) ** 2 + 4.0 * ap2))
    beta_t = alpha_prev * (1.0 - alpha_prev) / (ap2 + alpha_t)
    return alpha_t, beta_t


def theorem3_gamma(mu: float, delta: float, M: int) -> float:
    """The smoothing parameter choice from the proof of Theorem 3."""
    if delta / mu >= math.sqrt(M):
        return delta / math.sqrt(M) - mu
    return 0.0


def catalyst_inner_iterations(mu: float, delta: float, M: int, safety: float = 3.0) -> int:
    """Proposition 2/3's T_A up to the log factor: the inner linear rate is
    tau = (1/2) min((gamma+mu)^2/(delta^2+(gamma+mu)^2), 1/M); we run a
    `safety` multiple of 1/tau iterations per outer step."""
    gamma = theorem3_gamma(mu, delta, M)
    s = (gamma + mu) ** 2
    tau = 0.5 * min(s / (delta**2 + s), 1.0 / M)
    return int(math.ceil(safety / tau))
