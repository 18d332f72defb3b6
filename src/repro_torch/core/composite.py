"""Algorithm 4: SVRP for composite / constrained optimization (Section 15).

Port of `repro.core.composite`:

    min_x  F(x) = (1/M) sum_m f_m(x) + R(x)

with R convex and prox-friendly.  The update becomes
    x_{k+1} ~= prox_{eta f_m + eta R}(x_k - eta g_k),
and Theorem 5 gives the same O~((M + delta^2/mu^2) log 1/eps) communication
complexity as the unconstrained case.  The joint prox is solved by FISTA on
the strongly convex subproblem (plain PyTorch: the reference solves it in
jnp, with no kernel).

Everything runs over lanes: the state is ``S + (d,)`` with ``S = ()`` for
one trial or ``(B,)`` for a sweep, each lane with its own ``eta``, ``p``,
``smoothness`` and ``mu``; a prox of R acts on the last axis alone (the
l2-ball takes one norm per lane).  The client and refresh coin of round k
come from a `core.draws.Draws` record, drawn as svrp draws them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.types import RunResult, StepDef, scalar_hparam, scan_step_def
from repro_torch.device import problem_device


# ------------------------------------------------------------------ prox of R
def prox_l1(z: torch.Tensor, t) -> torch.Tensor:
    """Soft thresholding; ``t`` a scalar or broadcastable against ``z``."""
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


def prox_box(lo: float, hi: float) -> Callable:
    def _p(z, t):
        return torch.clamp(z, lo, hi)

    return _p


def prox_l2ball(radius: float) -> Callable:
    """Projection onto the l2 ball, one norm per lane (the last axis)."""

    def _p(z, t):
        n = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return torch.where(n <= radius, z, z * (radius / torch.clamp(n, min=1e-30)))

    return _p


def _lane(h, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-lane ``S`` hparam as a multiplier for ``S + (d,)`` rows."""
    h = torch.as_tensor(h, dtype=like.dtype, device=like.device)
    return h.unsqueeze(-1) if h.ndim else h


def joint_prox_fista(grad_fn: Callable, prox_R: Callable, z: torch.Tensor, eta, L, mu,
                     num_steps: int) -> torch.Tensor:
    """FISTA on  phi(y) = f_m(y) + 1/(2 eta)||y - z||^2 + R(y)  over lanes.

    The smooth part is (L + 1/eta)-smooth and (mu + 1/eta)-strongly convex;
    ``eta``, ``L`` and ``mu`` are scalars or per-lane ``S`` tensors."""
    eta, L, mu = _lane(eta, z), _lane(L, z), _lane(mu, z)
    Lp = L + 1.0 / eta
    mup = mu + 1.0 / eta
    step = 1.0 / Lp
    kappa = Lp / mup
    mom = (torch.sqrt(kappa) - 1.0) / (torch.sqrt(kappa) + 1.0)
    y, v = z, z
    for _ in range(num_steps):
        g = grad_fn(v) + (v - z) / eta
        y_next = prox_R(v - step * g, step)
        v = y_next + mom * (y_next - y)
        y = y_next
    return y


class CompositeSVRPParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor  # prox stepsize
    p: torch.Tensor  # anchor-refresh probability
    smoothness: torch.Tensor  # per-client L (FISTA stepsize of the joint prox)
    mu: torch.Tensor  # strong convexity (FISTA momentum of the joint prox)


class _State(NamedTuple):
    x: torch.Tensor
    w: torch.Tensor
    gbar: torch.Tensor
    comm: torch.Tensor


def composite_step_def(problem, x0: torch.Tensor, x_star: torch.Tensor, draws: Draws,
                       hp: CompositeSVRPParams, *, prox_R: Callable,
                       prox_steps: int = 80) -> StepDef:
    """Algorithm 4's round over the lanes of ``draws`` as a `StepDef`.

    ``x_star`` must be the COMPOSITE minimizer (e.g.
    `composite_minimizer_pgd`), not ``problem.minimizer()``.  comm is int32,
    as the reference's is under x64: 3M at the start, then 2 a round and a
    coin-gated 3M.  The full gradient at the new anchor is taken only on
    rounds where some lane refreshes (the host's mask)."""
    M = problem.num_clients
    lanes = draws.lanes
    eta = _lane(torch.as_tensor(hp.eta, dtype=x0.dtype, device=x0.device).broadcast_to(lanes), x0)

    def init():
        gbar = problem.full_grad(x0)
        tile = lambda v: v.expand(lanes + v.shape).contiguous()  # noqa: E731
        comm = torch.full(lanes, 3 * M, dtype=torch.int32, device=x0.device)
        return _State(tile(x0), tile(x0), tile(gbar), comm)

    def step(s: _State, k: int):
        m = draws.clients[k]
        g_k = s.gbar - problem.grad(m, s.w)
        z = s.x - eta * g_k
        x_next = joint_prox_fista(lambda y: problem.grad(m, y), prox_R, z, hp.eta,
                                  hp.smoothness, hp.mu, prox_steps)
        c = draws.coins[k]
        w_next = torch.where(c.unsqueeze(-1), x_next, s.w)
        gbar_next = s.gbar
        if draws.refresh[k]:
            gbar_next = torch.where(c.unsqueeze(-1), problem.full_grad(w_next), s.gbar)
        comm = s.comm + 2 + 3 * M * c.to(torch.int32)
        return _State(x_next, w_next, gbar_next, comm), (
            ((x_next - x_star) ** 2).sum(-1), comm)

    return StepDef(init, step, lambda s: s.x)


def composite_svrp_scan(problem, x0: torch.Tensor, x_star: torch.Tensor, draws: Draws,
                        hp: CompositeSVRPParams, *, num_steps: int, prox_R: Callable,
                        prox_steps: int = 80) -> RunResult:
    """``num_steps`` rounds of `composite_step_def`: one trajectory per lane."""
    sd = composite_step_def(problem, x0, x_star, draws, hp, prox_R=prox_R,
                            prox_steps=prox_steps)
    return scan_step_def(sd, num_steps)


def run_composite_svrp(problem, prox_R: Callable, x0: torch.Tensor, x_star: torch.Tensor, *,
                       eta: float, p: float, num_steps: int, smoothness: float, mu: float,
                       seed: int | None = None, draws: Draws | None = None,
                       prox_steps: int = 80, device=None) -> RunResult:
    """Algorithm 4 for one trial on ``device`` (default CUDA), with the
    clients and coins of ``draws`` (a per-trial record) or drawn from ``seed``."""
    dev = problem_device(problem, device)
    hp = CompositeSVRPParams(*(scalar_hparam(v, dev) for v in (eta, p, smoothness, mu)))
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, p, device=dev)
    return composite_svrp_scan(problem, x0, x_star, draws, hp, num_steps=num_steps,
                               prox_R=prox_R, prox_steps=prox_steps)


def composite_minimizer_pgd(problem, prox_R: Callable, *, L, num_steps: int = 5000):
    """The composite problem's solution by full proximal gradient from zero."""
    step = 1.0 / L
    dtype = problem.b.dtype if hasattr(problem, "b") else torch.float64
    x = torch.zeros(problem.dim, dtype=dtype, device=problem.device)
    for _ in range(num_steps):
        x = prox_R(x - step * problem.full_grad(x), step)
    return x
