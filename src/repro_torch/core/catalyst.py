"""Algorithm 3: Catalyst acceleration wrapped around SVRP (Catalyzed SVRP).

Port of `repro.core.catalyst`.  Each outer step t approximately minimizes

    h_t(x) = f(x) + gamma/2 ||x - y_{t-1}||^2

with SVRP as the inner solver, then extrapolates.  Theorem 3: gamma =
delta/sqrt(M) - mu when delta/mu >= sqrt(M), else 0.

* `catalyzed_step_def` — the whole method over the lanes of its draws (one
  trial or a sweep) as a `StepDef` of ``num_outer * inner_steps`` rounds:
  the outer recurrence `rounds.catalyst_step_def` with each stage's inner
  SVRP rounds on the per-lane shifted subproblem (``problem.shifted_lanes``)
  through the registry prox solver; the online engine steps it a chunk at a
  time, `catalyzed_svrp_scan` runs it for the whole horizon and
  `run_catalyzed_svrp` for one trial with the proof's parameters.
* `run_catalyst` — the generic host-side outer loop over ANY inner solver;
  `run_catalyzed_svrp_host` runs it with `run_svrp` inside.

The fused sweep runs the same recurrence in `rounds._catalyzed_batched_scan`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.rounds import catalyst_step_def, make_registry_ops
from repro_torch.core.svrp import SVRPParams, run_svrp, theorem2_stepsize
from repro_torch.core.types import RunResult, StepDef, scalar_hparam, scan_step_def
from repro_torch.device import problem_device


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


def catalyzed_step_def(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    hp: CatalyzedSVRPParams,
    draws: Draws,
    *,
    num_outer: int,
    inner_steps: int,
    prox_solver: str = "exact",
    prox_steps: int = 50,
    prox_tol: float = 1e-10,
    channel: str | None = None,
) -> StepDef:
    """Catalyzed SVRP over the lanes of ``draws`` (``(T, K)`` for one trial,
    ``(T, K, B)`` for a sweep; stage t's ``(K, B)`` block is the
    reference's per-stage ``split``), one round a step.  Stage t solves lane
    s's subproblem f + gamma_s/2 ||x - y_s||^2 by ``inner_steps`` SVRP
    rounds; distances are measured to the ORIGINAL optimum.  The spectral
    solver's factors are the base problem's, computed once here and shifted
    by gamma per lane."""
    from repro_torch.core.prox import get_prox_solver

    get_prox_solver(prox_solver, problem)
    base_factors = problem.prox_factors() if prox_solver == "spectral" else None
    gamma = torch.as_tensor(hp.gamma, dtype=x0.dtype, device=x0.device).broadcast_to(draws.lanes)
    inner_hp = SVRPParams(eta=hp.eta, p=hp.p, smoothness=hp.smoothness)

    def stage_ops(y_prev, stage_draws):
        return make_registry_ops(
            "svrp", problem.shifted_lanes(gamma, y_prev), x0, x_star, inner_hp, stage_draws,
            prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol,
            prox_factors=base_factors, channel=channel,
        )

    return catalyst_step_def(stage_ops, x0, hp, draws, num_outer=num_outer,
                             inner_steps=inner_steps)


def catalyzed_svrp_scan(problem, x0: torch.Tensor, x_star: torch.Tensor, draws: Draws,
                        hp: CatalyzedSVRPParams, *, num_outer: int, inner_steps: int,
                        **static) -> RunResult:
    """The whole horizon of `catalyzed_step_def`: one trajectory per lane."""
    sd = catalyzed_step_def(problem, x0, x_star, hp, draws, num_outer=num_outer,
                            inner_steps=inner_steps, **static)
    return scan_step_def(sd, num_outer * inner_steps)


def run_catalyst(
    problem,
    solver,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    *,
    mu: float,
    gamma: float,
    num_outer: int,
    draws: Draws,
) -> RunResult:
    """Generic Catalyst outer loop (Algorithm 3) over any inner solver.

    ``solver(h_t, x_init, x_star, stage_draws) -> RunResult`` must
    approximately minimize the shifted problem ``h_t``; stage t gets
    ``draws.stage(t)``.  The outer loop runs on the host in floats (T is
    small); trajectories are concatenated with cumulative comm offsets."""
    q = mu / (mu + gamma)
    x_prev = y_prev = x0
    alpha_prev = math.sqrt(q)
    comm_offset = 0
    d2_chunks, comm_chunks = [], []
    for t in range(num_outer):
        h_t = problem.shifted(gamma, y_prev)
        # Distances are always measured to the ORIGINAL optimum.
        res = solver(h_t, x_prev, x_star, draws.stage(t))
        x_t = res.x_final

        # alpha_t solves alpha^2 = (1 - alpha) alpha_{t-1}^2 + q alpha.
        ap2 = alpha_prev**2
        alpha_t = 0.5 * ((q - ap2) + math.sqrt((q - ap2) ** 2 + 4.0 * ap2))
        beta_t = alpha_prev * (1.0 - alpha_prev) / (ap2 + alpha_t)
        y_t = x_t + beta_t * (x_t - x_prev)

        d2_chunks.append(res.dist_sq)
        comm_chunks.append(res.comm + comm_offset)
        comm_offset = int(comm_chunks[-1][-1])
        x_prev, y_prev, alpha_prev = x_t, y_t, alpha_t

    return RunResult(dist_sq=torch.cat(d2_chunks), comm=torch.cat(comm_chunks), x_final=x_prev)


def _proof_params(problem, mu, delta, gamma, inner_steps, p):
    """Theorem 3's choices where the caller gave none: gamma, T_A, p = 1/M."""
    M = problem.num_clients
    gamma = theorem3_gamma(mu, delta, M) if gamma is None else gamma
    inner_steps = catalyst_inner_iterations(mu, delta, M) if inner_steps is None else inner_steps
    return gamma, inner_steps, 1.0 / M if p is None else p


def run_catalyzed_svrp(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    *,
    mu: float,
    delta: float,
    num_outer: int,
    seed: int | None = None,
    draws: Draws | None = None,
    gamma: float | None = None,
    inner_steps: int | None = None,
    p: float | None = None,
    device=None,
) -> RunResult:
    """Catalyzed SVRP — Theorem 3's method, with the proof's parameter choices:
    gamma = delta/sqrt(M) - mu (case a) or 0 (case b), inner eta =
    (mu+gamma)/(2 delta^2), p = 1/M, and T_A inner iterations per outer step;
    on ``device`` (default CUDA) with a ``(T, K)`` record or ``seed``."""
    dev = problem_device(problem, device)
    gamma, inner_steps, p = _proof_params(problem, mu, delta, gamma, inner_steps, p)
    eta_inner = theorem2_stepsize(mu + gamma, delta)  # eta = (mu+gamma)/(2 delta^2)
    hp = CatalyzedSVRPParams(mu=scalar_hparam(mu, dev), gamma=scalar_hparam(gamma, dev),
                             eta=scalar_hparam(eta_inner, dev), p=scalar_hparam(p, dev),
                             smoothness=scalar_hparam(0.0, dev))
    draws = trial_draws(draws, seed, problem.num_clients, inner_steps, p,
                        num_outer=num_outer, device=dev)
    return catalyzed_svrp_scan(problem, x0, x_star, draws, hp, num_outer=num_outer,
                               inner_steps=inner_steps)


def run_catalyzed_svrp_host(
    problem,
    x0: torch.Tensor,
    x_star: torch.Tensor,
    *,
    mu: float,
    delta: float,
    num_outer: int,
    seed: int | None = None,
    draws: Draws | None = None,
    gamma: float | None = None,
    inner_steps: int | None = None,
    p: float | None = None,
    device=None,
) -> RunResult:
    """The host-loop implementation (`run_catalyst` over `run_svrp`), kept
    for equivalence testing against `catalyzed_svrp_scan`."""
    dev = problem_device(problem, device)
    gamma, inner_steps, p = _proof_params(problem, mu, delta, gamma, inner_steps, p)
    eta_inner = theorem2_stepsize(mu + gamma, delta)
    draws = trial_draws(draws, seed, problem.num_clients, inner_steps, p,
                        num_outer=num_outer, device=dev)

    def solver(h_t, x_init, x_star_, stage_draws):
        return run_svrp(h_t, x_init, x_star_, eta=eta_inner, p=p, num_steps=inner_steps,
                        draws=stage_draws, device=dev)

    return run_catalyst(problem, solver, x0, x_star, mu=mu, gamma=gamma,
                        num_outer=num_outer, draws=draws)
