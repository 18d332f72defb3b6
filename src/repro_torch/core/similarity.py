"""Estimators for the constants of Assumptions 1-2 (delta, mu, L, sigma_*).

Port of `repro.core.similarity`.  For quadratics the exact values come from
`QuadraticProblem`; these estimators are the *measurement* tools the paper
uses for real data, where only sampled gradient differences are available.

The reference draws its point pairs from JAX keys.  Here they come from a
`torch.Generator` (on the problem's device), or are passed in as ``pairs =
(X, Y)``, two ``(num_pairs, d)`` tensors used as they are.
"""
from __future__ import annotations

import torch


def _pairs(problem, generator, num_pairs: int, radius: float, pairs):
    if pairs is not None:
        return pairs
    dtype = next(getattr(problem, a) for a in ("A", "Z") if hasattr(problem, a)).dtype
    X, Y = (radius * torch.randn(num_pairs, problem.dim, generator=generator, dtype=dtype,
                                 device=problem.device) for _ in range(2))
    return X, Y


def empirical_delta(problem, generator: torch.Generator | None = None, num_pairs: int = 64,
                    radius: float = 1.0, *, pairs=None) -> torch.Tensor:
    """Monte-Carlo lower estimate of delta from Assumption 1's defining ratio:

        delta(x, y)^2 = (1/M) sum_m ||D_m(x) - D_m(y)||^2 / ||x - y||^2,
        D_m(x) = grad f_m(x) - grad f(x),

    maximized over the sampled pairs (x, y)."""
    X, Y = _pairs(problem, generator, num_pairs, radius, pairs)
    M = problem.num_clients
    ms = torch.arange(M, device=X.device)
    ratios = []
    for x, y in zip(X, Y):
        gx = problem.grad(ms, x.expand(M, -1)) - problem.full_grad(x)
        gy = problem.grad(ms, y.expand(M, -1)) - problem.full_grad(y)
        num = ((gx - gy) ** 2).sum(-1).mean()
        ratios.append(num / ((x - y) ** 2).sum())
    return torch.sqrt(torch.stack(ratios).max())


def empirical_smoothness(problem, generator: torch.Generator | None = None,
                         num_pairs: int = 64, radius: float = 1.0, *,
                         pairs=None) -> torch.Tensor:
    """Monte-Carlo estimate of L for the average objective f."""
    X, Y = _pairs(problem, generator, num_pairs, radius, pairs)
    ratios = torch.sqrt(((problem.full_grad(X) - problem.full_grad(Y)) ** 2).sum(-1)
                        / ((X - Y) ** 2).sum(-1))
    return ratios.max()


def grad_noise_at(problem, x: torch.Tensor) -> torch.Tensor:
    """sigma^2(x) = (1/M) sum_m ||grad f_m(x)||^2 (Theorem 1's sigma_*^2 at x_*)."""
    M = problem.num_clients
    g = problem.grad(torch.arange(M, device=x.device), x.expand(M, -1))
    return (g ** 2).sum(-1).mean()
