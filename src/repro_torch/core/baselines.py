"""Every algorithm the paper compares against (Table 1 / Figure 1).

Port of `repro.core.baselines`.  All follow the same communication
accounting as SVRP (one vector exchange server<->one client = 1 step):

* distributed SGD with client sampling             — 2 / iter
* loopless SVRG (Kovalev et al., 2020)             — 2 + 3pM / iter (expected)
* SCAFFOLD (Karimireddy et al., 2020), sampled     — 2 / round
* DANE/SONATA surrogate minimization               — 2M + 2 / round
* Accelerated Extragradient sliding (Kovalev 2022) — 4M + 2 / round

Each baseline is one `core.types.StepDef` written over LANES: state is
``S + (d,)`` with ``S = ()`` for one trial and ``S = (B,)`` for a sweep,
``S`` being the shape of the hparam fields, so the same step serves
`run_sequential`'s per-trial drivers and `run_batch`'s lane batch.  The
stochastic ones read round k of a `core.draws.Draws` record: sgd and
scaffold one client a round, svrg a client and a refresh coin; dane and
acc_extragradient draw nothing.  ``*_scan`` runs a step def for a horizon,
``run_*`` is the per-trial driver.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.draws import Draws, trial_draws
from repro_torch.core.prox import prox_newton
from repro_torch.core.types import RunResult, StepDef, scalar_hparam, scan_step_def
from repro_torch.device import problem_device


def _lanes(hp) -> tuple:
    return tuple(torch.as_tensor(hp[0]).shape)


def _per_lane(h, x0, lanes) -> torch.Tensor:
    """A hparam as a per-lane ``S`` tensor of the iterate's dtype."""
    return torch.as_tensor(h, dtype=x0.dtype, device=x0.device).broadcast_to(lanes)


def _tile(x0, lanes) -> torch.Tensor:
    return x0.expand(lanes + x0.shape).contiguous()


def _dist_sq(x, x_star):
    return ((x - x_star) ** 2).sum(-1)


# --------------------------------------------------------------------------- SGD
class SGDParams(NamedTuple):
    stepsize: torch.Tensor


def sgd_step_def(problem, x0, x_star, hp: SGDParams, draws: Draws) -> StepDef:
    lanes = _lanes(hp)
    stepsize = _per_lane(hp.stepsize, x0, lanes).unsqueeze(-1)

    def step(carry, k):
        x, comm = carry
        m = draws.clients[k]
        x_next = x - stepsize * problem.grad(m, x)
        comm = comm + 2
        return (x_next, comm), (_dist_sq(x_next, x_star), comm)

    def init():
        return _tile(x0, lanes), torch.zeros(lanes, dtype=torch.int64, device=x0.device)

    return StepDef(init, step, lambda s: s[0])


def sgd_scan(problem, x0, x_star, draws: Draws, hp: SGDParams, *, num_steps: int) -> RunResult:
    return scan_step_def(sgd_step_def(problem, x0, x_star, hp, draws), num_steps)


def run_sgd(problem, x0, x_star, *, stepsize, num_steps: int, seed: int | None = None,
            draws: Draws | None = None, device=None) -> RunResult:
    dev = problem_device(problem, device)
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, device=dev)
    return sgd_scan(problem, x0, x_star, draws, SGDParams(scalar_hparam(stepsize, dev)),
                    num_steps=num_steps)


# ------------------------------------------------------------------- loopless SVRG
class SVRGParams(NamedTuple):
    stepsize: torch.Tensor
    p: torch.Tensor


class _SVRGState(NamedTuple):
    x: torch.Tensor
    w: torch.Tensor
    gbar: torch.Tensor
    comm: torch.Tensor


def svrg_step_def(problem, x0, x_star, hp: SVRGParams, draws: Draws) -> StepDef:
    """L-SVRG: x_{k+1} = x_k - gamma (grad f_m(x_k) - grad f_m(w_k) + grad f(w_k)).

    The anchor gradient is recomputed only on rounds where some lane's coin
    refreshes (`Draws.refresh`, known on the host), selected per lane."""
    M = problem.num_clients
    lanes = _lanes(hp)
    stepsize = _per_lane(hp.stepsize, x0, lanes).unsqueeze(-1)

    def init():
        xB = _tile(x0, lanes)
        return _SVRGState(xB, xB, _tile(problem.full_grad(x0), lanes),
                          torch.full(lanes, 3 * M, dtype=torch.int32, device=x0.device))

    def step(s: _SVRGState, k):
        m = draws.clients[k]
        g = problem.grad(m, s.x) - problem.grad(m, s.w) + s.gbar
        x_next = s.x - stepsize * g
        c = draws.coins[k]
        w_next = torch.where(c.unsqueeze(-1), x_next, s.w)
        gbar_next = s.gbar
        if draws.refresh[k]:
            gbar_next = torch.where(c.unsqueeze(-1), problem.full_grad(w_next), s.gbar)
        comm = s.comm + 2 + 3 * M * c.to(torch.int32)
        return _SVRGState(x_next, w_next, gbar_next, comm), (_dist_sq(x_next, x_star), comm)

    return StepDef(init, step, lambda s: s.x)


def svrg_scan(problem, x0, x_star, draws: Draws, hp: SVRGParams, *, num_steps: int) -> RunResult:
    return scan_step_def(svrg_step_def(problem, x0, x_star, hp, draws), num_steps)


def run_svrg(problem, x0, x_star, *, stepsize, p, num_steps: int, seed: int | None = None,
             draws: Draws | None = None, device=None) -> RunResult:
    dev = problem_device(problem, device)
    draws = trial_draws(draws, seed, problem.num_clients, num_steps, p, device=dev)
    hp = SVRGParams(scalar_hparam(stepsize, dev), scalar_hparam(p, dev))
    return svrg_scan(problem, x0, x_star, draws, hp, num_steps=num_steps)


# ---------------------------------------------------------------------- SCAFFOLD
class ScaffoldParams(NamedTuple):
    local_lr: torch.Tensor
    global_lr: torch.Tensor


class _ScaffoldState(NamedTuple):
    x: torch.Tensor
    c_server: torch.Tensor
    c_clients: torch.Tensor  # S + (M, d)
    comm: torch.Tensor


def scaffold_step_def(problem, x0, x_star, hp: ScaffoldParams, draws: Draws, *,
                      local_steps: int) -> StepDef:
    """SCAFFOLD with client sampling (one client per round), Option II variates."""
    M, d = problem.num_clients, x0.shape[-1]
    lanes = _lanes(hp)
    local_lr = _per_lane(hp.local_lr, x0, lanes)
    global_lr = _per_lane(hp.global_lr, x0, lanes).unsqueeze(-1)
    lr = local_lr.unsqueeze(-1)
    drift_scale = (local_steps * local_lr).unsqueeze(-1)

    def init():
        dev = x0.device
        return _ScaffoldState(
            x=_tile(x0, lanes),
            c_server=torch.zeros(lanes + (d,), dtype=x0.dtype, device=dev),
            c_clients=torch.zeros(lanes + (M, d), dtype=x0.dtype, device=dev),
            comm=torch.zeros(lanes, dtype=torch.int64, device=dev),
        )

    def round_(s: _ScaffoldState, k):
        m = draws.clients[k]
        row = m[..., None, None].expand(lanes + (1, d))  # client m's row of c_clients
        c_m = s.c_clients.gather(-2, row).squeeze(-2)
        y = s.x
        for _ in range(local_steps):
            y = y - lr * (problem.grad(m, y) - c_m + s.c_server)
        c_m_new = c_m - s.c_server + (s.x - y) / drift_scale
        x_next = s.x + global_lr * (y - s.x)
        c_server_next = s.c_server + (c_m_new - c_m) / M
        c_clients_next = s.c_clients.scatter(-2, row, c_m_new.unsqueeze(-2))
        comm = s.comm + 2
        return _ScaffoldState(x_next, c_server_next, c_clients_next, comm), (
            _dist_sq(x_next, x_star), comm)

    return StepDef(init, round_, lambda s: s.x)


def scaffold_scan(problem, x0, x_star, draws: Draws, hp: ScaffoldParams, *, num_rounds: int,
                  local_steps: int) -> RunResult:
    sd = scaffold_step_def(problem, x0, x_star, hp, draws, local_steps=local_steps)
    return scan_step_def(sd, num_rounds)


def run_scaffold(problem, x0, x_star, *, local_lr, global_lr, local_steps: int,
                 num_rounds: int, seed: int | None = None, draws: Draws | None = None,
                 device=None) -> RunResult:
    dev = problem_device(problem, device)
    draws = trial_draws(draws, seed, problem.num_clients, num_rounds, device=dev)
    hp = ScaffoldParams(scalar_hparam(local_lr, dev), scalar_hparam(global_lr, dev))
    return scaffold_scan(problem, x0, x_star, draws, hp, num_rounds=num_rounds,
                         local_steps=local_steps)


# ------------------------------------------- surrogate solvers (DANE / extragradient)
def _surrogate_min(problem, s_idx, d_lin, y, theta):
    """argmin_x  f_s(x) + <d_lin, x> + theta/2 ||x - y||^2, per lane.

    ``s_idx`` and ``theta`` are ``S``, ``d_lin`` and ``y`` ``S + (d,)``.
    Closed form for quadratics; otherwise this is exactly
    prox_{(1/theta)(f_s + <d_lin, .>)}(y), solved by the registry's GUARDED
    Newton (`core.prox.prox_newton`: backtracking + gradient-norm early exit,
    each lane on its own)."""
    if hasattr(problem, "A"):  # QuadraticProblem
        eye = torch.eye(problem.dim, dtype=y.dtype, device=y.device)
        H = problem.A[s_idx] + theta[..., None, None] * eye
        rhs = problem.b[s_idx] - d_lin + theta.unsqueeze(-1) * y
        return torch.linalg.solve_ex(H, rhs)[0]  # no device wait: H >= theta I

    return prox_newton(
        lambda x: problem.grad(s_idx, x) + d_lin,
        lambda x: problem.hessian(s_idx, x),
        y, 1.0 / theta, max_steps=40, tol=1e-11,
    )


class DANEParams(NamedTuple):
    theta: torch.Tensor


def dane_step_def(problem, x0, x_star, hp: DANEParams, draws: Draws | None = None, *,
                  surrogate_client: int = 0) -> StepDef:
    """DANE/SONATA-style surrogate minimization (full participation).
    Deterministic: the round ignores k and ``draws``."""
    del draws
    M = problem.num_clients
    lanes = _lanes(hp)
    theta = _per_lane(hp.theta, x0, lanes)
    s_idx = torch.full(lanes, surrogate_client, dtype=torch.int64, device=x0.device)

    def round_(carry, k):
        x, comm = carry
        d_lin = problem.full_grad(x) - problem.grad(s_idx, x)
        x_next = _surrogate_min(problem, s_idx, d_lin, x, theta)
        comm = comm + 2 * M + 2
        return (x_next, comm), (_dist_sq(x_next, x_star), comm)

    def init():
        return _tile(x0, lanes), torch.zeros(lanes, dtype=torch.int64, device=x0.device)

    return StepDef(init, round_, lambda s: s[0])


def dane_scan(problem, x0, x_star, draws: Draws | None, hp: DANEParams, *, num_rounds: int,
              surrogate_client: int = 0) -> RunResult:
    sd = dane_step_def(problem, x0, x_star, hp, surrogate_client=surrogate_client)
    return scan_step_def(sd, num_rounds)


def run_dane(problem, x0, x_star, *, theta, num_rounds: int, surrogate_client: int = 0,
             device=None) -> RunResult:
    """x_{t+1} = argmin_x f_s(x) + <grad f(y) - grad f_s(y), x> + theta/2||x-y||^2,
    theta ~ delta gives the O~(delta/mu) round complexity of SONATA.
    Comm: full gradient (2M) + surrogate exchange (2) per round."""
    dev = problem_device(problem, device)
    return dane_scan(problem, x0, x_star, None, DANEParams(scalar_hparam(theta, dev)),
                     num_rounds=num_rounds, surrogate_client=surrogate_client)


class AccEGParams(NamedTuple):
    theta: torch.Tensor
    mu: torch.Tensor


class _AccEGState(NamedTuple):
    x: torch.Tensor
    x_prev: torch.Tensor
    comm: torch.Tensor


def acc_extragradient_step_def(problem, x0, x_star, hp: AccEGParams, draws: Draws | None = None,
                               *, surrogate_client: int = 0) -> StepDef:
    """Accelerated Extragradient sliding (Kovalev et al., 2022 family):
    O~(sqrt(delta/mu) M) communication under Assumption 1.

        y_t     = x_t + beta (x_t - x_{t-1})
        u_t     = argmin_x f_s(x) + <grad p(y_t), x> + theta/2 ||x - y_t||^2
        x_{t+1} = argmin_x f_s(x) + <grad p(u_t), x> + theta/2 ||x - y_t||^2

    with p = f - f_s, beta the strongly-convex Nesterov coefficient for
    kappa = max(theta/mu, 1).  Comm: 4M + 2 per round.  Deterministic."""
    del draws
    M = problem.num_clients
    lanes = _lanes(hp)
    theta = _per_lane(hp.theta, x0, lanes)
    s_idx = torch.full(lanes, surrogate_client, dtype=torch.int64, device=x0.device)
    kappa = torch.clamp(theta / _per_lane(hp.mu, x0, lanes), min=1.0)
    beta = ((torch.sqrt(kappa) - 1.0) / (torch.sqrt(kappa) + 1.0)).unsqueeze(-1)

    def gradp(x):
        return problem.full_grad(x) - problem.grad(s_idx, x)

    def round_(s: _AccEGState, k):
        y = s.x + beta * (s.x - s.x_prev)
        u = _surrogate_min(problem, s_idx, gradp(y), y, theta)
        x_next = _surrogate_min(problem, s_idx, gradp(u), y, theta)
        comm = s.comm + 4 * M + 2
        return _AccEGState(x_next, s.x, comm), (_dist_sq(x_next, x_star), comm)

    def init():
        xB = _tile(x0, lanes)
        return _AccEGState(xB, xB, torch.zeros(lanes, dtype=torch.int64, device=x0.device))

    return StepDef(init, round_, lambda s: s.x)


def acc_extragradient_scan(problem, x0, x_star, draws: Draws | None, hp: AccEGParams, *,
                           num_rounds: int, surrogate_client: int = 0) -> RunResult:
    sd = acc_extragradient_step_def(problem, x0, x_star, hp, surrogate_client=surrogate_client)
    return scan_step_def(sd, num_rounds)


def run_acc_extragradient(problem, x0, x_star, *, theta, mu, num_rounds: int,
                          surrogate_client: int = 0, device=None) -> RunResult:
    dev = problem_device(problem, device)
    hp = AccEGParams(scalar_hparam(theta, dev), scalar_hparam(mu, dev))
    return acc_extragradient_scan(problem, x0, x_star, None, hp, num_rounds=num_rounds,
                                  surrogate_client=surrogate_client)
