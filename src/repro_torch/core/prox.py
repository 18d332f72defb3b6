"""Pluggable approximate proximal-point solvers (the paper's Algorithm 7 and friends).

Port of `repro.core.prox`.  A b-approximation of prox_{eta h}(z) is any y with
||y - prox_{eta h}(z)||^2 <= b.

Solvers work on any leading batch of LANES: ``z`` is ``S + (d,)`` and the
oracles map ``S + (d,)`` rows to ``S + (d,)`` gradients (``S + (d, d)``
Hessians).  Where the reference runs a `lax.while_loop` under `vmap`, the
port runs one loop whose lanes stop as they converge: a finished lane keeps
its carry while the others go on, so each lane follows exactly the trajectory
it would follow alone.  Loop exits test the lanes on the host once per
iteration; none of these solvers is on the fused sweep path.

Solver registry
---------------
``get_prox_solver(name, problem)`` validates the (solver, problem) pair and
returns a `ProxSolver` with the reference's two-phase contract:
``prepare(problem) -> hoisted`` once, then
``solve(problem, hoisted, m, z, eta, *, smoothness, steps, tol) -> y``.

==========  =======================  ==========================================
name        problem requirement      method
==========  =======================  ==========================================
exact       ``.prox``                closed-form (quadratic) / guarded Newton
spectral    ``.prox_spectral``       hoisted eigendecomposition; QUADRATIC-ONLY
gd          ``.grad`` + smoothness   Algorithm 7 at stepsize 1/(L + 1/eta)
newton      ``.hessian``             damped Newton + backtracking + early exit
newton-cg   ``.grad``                inexact Newton, CG on Hessian-vector
                                     products by `torch.func.jvp`
==========  =======================  ==========================================
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


def _lane(v: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar (S,) as a multiplier for (S, d) rows (0-d stays)."""
    return v.unsqueeze(-1) if v.ndim else v


def _norm(g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(g, dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _select(mask: torch.Tensor, new, old):
    """Per-lane carry update: lanes where ``mask`` holds take ``new``."""
    return tuple(
        torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - mask.ndim)), n, o)
        for n, o in zip(new, old)
    )


def prox_gd(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    eta: float,
    L: float,
    num_steps: int,
    y0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Algorithm 7: gradient descent on  phi(y) = h(y) + ||y - z||^2 / (2 eta)
    at the theory stepsize beta = 1/(L + 1/eta), for a static step count.
    ``eta`` and ``L`` are floats or per-lane ``S`` tensors for ``S + (d,)`` rows."""
    beta = _lane_of(1.0 / (L + 1.0 / eta))
    eta = _lane_of(eta)
    y = z if y0 is None else y0
    for _ in range(num_steps):
        y = y - beta * (grad_fn(y) + (y - z) / eta)
    return y


def _lane_of(v):
    """A float stays; a per-lane tensor becomes a multiplier for rows."""
    return _lane(v) if isinstance(v, torch.Tensor) else v


def gd_row_scalars(z: torch.Tensor, eta, L) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 7's per-row ``(beta, inv_eta)`` = ``(1/(L + 1/eta), 1/eta)``
    for ``(B, d)`` targets, from per-row or scalar ``eta`` and ``L``."""
    B = z.shape[0]
    eta = torch.as_tensor(eta, dtype=z.dtype, device=z.device).broadcast_to((B,))
    L = torch.as_tensor(L, dtype=z.dtype, device=z.device).broadcast_to((B,))
    return 1.0 / (L + 1.0 / eta), 1.0 / eta


def prox_gd_batched(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    eta,
    L,
    num_steps: int,
    y0: torch.Tensor | None = None,
    *,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Algorithm 7 across a whole sweep batch at once.

    `z`: `(B, d)` prox targets; `eta`, `L`: per-trial `(B,)` scalars (or
    broadcastable); `grad_fn` maps `(B, d) -> (B, d)`.  With `use_kernel=True`
    each GD step's update `y - beta (g + (y - z)/eta)` is one launch of the
    batched kernel (`kernels.prox_update_batched`, which takes its plain
    version for CPU tensors); otherwise it is the identical torch expression.
    """
    beta, inv_eta = gd_row_scalars(z, eta, L)
    y = z if y0 is None else y0

    if use_kernel:
        from repro_torch.kernels.prox_update import prox_update_batched

        for _ in range(num_steps):
            y = prox_update_batched(y, grad_fn(y), z, beta, inv_eta)
        return y
    for _ in range(num_steps):
        y = y - beta[:, None] * (grad_fn(y) + (y - z) * inv_eta[:, None])
    return y


def prox_agd(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    eta: float,
    L: float,
    mu: float,
    num_steps: int,
    y0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Nesterov AGD on phi — the accelerated local solver the paper invokes for
    its computational-complexity bounds (O(sqrt(kappa) log 1/b) accesses)."""
    Lp = L + 1.0 / eta
    mup = mu + 1.0 / eta
    beta_step = 1.0 / Lp
    sk = (Lp / mup) ** 0.5
    momentum = (sk - 1.0) / (sk + 1.0)
    y = v = z if y0 is None else y0
    for _ in range(num_steps):
        g = grad_fn(v) + (v - z) / eta
        y_next = v - beta_step * g
        v = y_next + momentum * (y_next - y)
        y = y_next
    return y


# --------------------------------------------------------------- guarded Newton
def _backtrack(phi_grad, y, g, gnorm, direction, max_backtracks: int):
    """Backtracking line search on the gradient-norm merit, per lane:
    accept ``||grad phi(y + t d)|| <= (1 - c t) ||grad phi(y)||`` (c = 0.1),
    halving t otherwise; the test is written as ``~(accept)`` so a NaN trial
    gradient keeps halving.  A lane that never decreases stays at y."""
    c = 0.1

    def trial(t):
        y_t = y + _lane(t) * direction
        g_t = phi_grad(y_t)
        return y_t, g_t, _norm(g_t)

    t = torch.ones_like(gnorm)
    k = torch.zeros(gnorm.shape, dtype=torch.int64, device=gnorm.device)
    y_t, g_t, gn_t = trial(t)

    def pending():
        return ~(gn_t <= (1.0 - c * t) * gnorm) & (k < max_backtracks)

    active = pending()
    while bool(active.any()):
        t = torch.where(active, 0.5 * t, t)
        y_t, g_t, gn_t = _select(active, trial(t), (y_t, g_t, gn_t))
        k = k + active.to(k.dtype)
        active = pending()
    accept = gn_t < gnorm
    return _select(accept, (y_t, g_t, gn_t), (y, g, gnorm))


def prox_newton(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    hess_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    eta,
    max_steps: int = 50,
    tol: float = 1e-10,
    y0: torch.Tensor | None = None,
    max_backtracks: int = 30,
) -> torch.Tensor:
    """Damped Newton on  phi(y) = h(y) + ||y - z||^2/(2 eta), with backtracking
    and an exit once ||grad phi|| <= tol (each lane on its own)."""
    y = z if y0 is None else y0
    inv_eta = 1.0 / torch.as_tensor(eta, dtype=z.dtype, device=z.device)
    eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)

    def phi_grad(v):
        return grad_fn(v) + (v - z) * _lane(inv_eta)

    g = phi_grad(y)
    gnorm = _norm(g)
    it = torch.zeros(gnorm.shape, dtype=torch.int64, device=z.device)
    active = (gnorm > tol) & (it < max_steps)
    while bool(active.any()):
        H = hess_fn(y) + _lane(_lane(inv_eta)) * eye
        direction = -torch.linalg.solve(H, g)
        step = _backtrack(phi_grad, y, g, gnorm, direction, max_backtracks)
        y, g, gnorm = _select(active, step, (y, g, gnorm))
        it = it + active.to(it.dtype)
        active = (gnorm > tol) & (it < max_steps)
    return y


def prox_newton_cg(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    eta,
    max_steps: int = 50,
    tol: float = 1e-10,
    y0: torch.Tensor | None = None,
    cg_steps: int = 25,
    max_backtracks: int = 30,
) -> torch.Tensor:
    """Inexact Newton on phi via CG over Hessian-VECTOR products.

    The Newton system (H_h + I/eta) d = -g is solved by CG to the
    Eisenstat–Walker forcing tolerance min(0.5, sqrt(||g||)) ||g||, with each
    hvp one forward-mode `torch.func.jvp` of grad_fn at y (the reference
    linearizes once per outer step; `torch.func.linearize` traces grad_fn
    anew on every call, which costs far more than the primal each jvp
    repeats).  Each outer step passes the same backtracking guard as
    `prox_newton`."""
    y = z if y0 is None else y0
    inv_eta = 1.0 / torch.as_tensor(eta, dtype=z.dtype, device=z.device)

    def phi_grad(v):
        return grad_fn(v) + (v - z) * _lane(inv_eta)

    def cg_solve(y, g, gnorm):
        def hvp(v):
            return torch.func.jvp(grad_fn, (y,), (v,))[1] + v * _lane(inv_eta)

        target = torch.clamp(torch.sqrt(gnorm), max=0.5) * gnorm
        d = torch.zeros_like(g)
        r = -g
        p = r
        rs = _dot(r, r)
        k = torch.zeros(gnorm.shape, dtype=torch.int64, device=g.device)
        active = (torch.sqrt(rs) > target) & (k < cg_steps)
        while bool(active.any()):
            Hp = hvp(p)
            alpha = rs / _dot(p, Hp)
            d_n = d + _lane(alpha) * p
            r_n = r - _lane(alpha) * Hp
            rs_n = _dot(r_n, r_n)
            p_n = r_n + _lane(rs_n / rs) * p
            d, r, p, rs = _select(active, (d_n, r_n, p_n, rs_n), (d, r, p, rs))
            k = k + active.to(k.dtype)
            active = (torch.sqrt(rs) > target) & (k < cg_steps)
        return d

    g = phi_grad(y)
    gnorm = _norm(g)
    it = torch.zeros(gnorm.shape, dtype=torch.int64, device=z.device)
    active = (gnorm > tol) & (it < max_steps)
    while bool(active.any()):
        direction = cg_solve(y, g, gnorm)
        step = _backtrack(phi_grad, y, g, gnorm, direction, max_backtracks)
        y, g, gnorm = _select(active, step, (y, g, gnorm))
        it = it + active.to(it.dtype)
        active = (gnorm > tol) & (it < max_steps)
    return y


# -------------------------------------------------------------- solver registry
class ProxSolver(NamedTuple):
    """One registered local prox solver (see the module docstring's contract)."""

    name: str
    requires: tuple[str, ...]  # problem attributes the solver dispatches on
    quadratic_only: bool  # True -> reject problems without the closed quadratic form
    prepare: Callable  # (problem) -> hoisted aux (run once, outside the rounds)
    solve: Callable  # (problem, hoisted, m, z, eta, *, smoothness, steps, tol) -> y


def _no_prepare(problem):
    return None


def _local_oracles(problem, m):
    """Client-m (grad_fn, hess_fn), with the data gather hoisted when the
    problem offers a `local_oracle` hook."""
    if hasattr(problem, "local_oracle"):
        return problem.local_oracle(m)
    return (
        lambda y: problem.grad(m, y),
        lambda y: problem.hessian(m, y) if hasattr(problem, "hessian") else None,
    )


def _solve_exact(problem, hoisted, m, z, eta, *, smoothness, steps, tol):
    del hoisted, smoothness, steps, tol
    return problem.prox(m, z, eta)


def _prepare_spectral(problem):
    return problem.prox_factors()


def _solve_spectral(problem, hoisted, m, z, eta, *, smoothness, steps, tol):
    del smoothness, steps, tol
    return problem.prox_spectral(m, z, eta, hoisted)


def _solve_gd(problem, hoisted, m, z, eta, *, smoothness, steps, tol):
    del hoisted, tol
    grad_fn, _ = _local_oracles(problem, m)
    return prox_gd(grad_fn, z, eta, smoothness, steps)


def _solve_newton(problem, hoisted, m, z, eta, *, smoothness, steps, tol):
    del hoisted, smoothness
    grad_fn, hess_fn = _local_oracles(problem, m)
    return prox_newton(grad_fn, hess_fn, z, eta, max_steps=steps, tol=tol)


def _solve_newton_cg(problem, hoisted, m, z, eta, *, smoothness, steps, tol):
    del hoisted, smoothness
    grad_fn, _ = _local_oracles(problem, m)
    return prox_newton_cg(grad_fn, z, eta, max_steps=steps, tol=tol)


PROX_SOLVERS: dict[str, ProxSolver] = {
    "exact": ProxSolver("exact", ("prox",), False, _no_prepare, _solve_exact),
    "spectral": ProxSolver(
        "spectral", ("prox_spectral", "prox_factors"), True,
        _prepare_spectral, _solve_spectral,
    ),
    "gd": ProxSolver("gd", ("grad",), False, _no_prepare, _solve_gd),
    "newton": ProxSolver("newton", ("grad", "hessian"), False, _no_prepare, _solve_newton),
    "newton-cg": ProxSolver(
        "newton-cg", ("grad",), False, _no_prepare, _solve_newton_cg
    ),
}
# Underscore alias so grids/configs built from identifiers also resolve.
PROX_SOLVERS["newton_cg"] = PROX_SOLVERS["newton-cg"]


def get_prox_solver(name: str, problem=None) -> ProxSolver:
    """Resolve a solver by name, validating the (solver, problem) pair, with
    the failing requirement spelled out (the reference's error texts)."""
    if name not in PROX_SOLVERS:
        raise ValueError(
            f"unknown prox_solver {name!r}; available: "
            f"{sorted(set(s.name for s in PROX_SOLVERS.values()))}"
        )
    solver = PROX_SOLVERS[name]
    if problem is not None:
        missing = [a for a in solver.requires if not hasattr(problem, a)]
        if missing:
            kind = type(problem).__name__
            if solver.quadratic_only:
                raise ValueError(
                    f"prox_solver={solver.name!r} is a quadratic-only solver "
                    f"({kind} has no {'/'.join(missing)}); use 'newton', "
                    "'newton-cg', 'gd', or 'exact' for non-quadratic problems"
                )
            raise ValueError(
                f"prox_solver={solver.name!r} requires problem attributes "
                f"{missing}, which {kind} does not provide"
            )
    return solver


def gd_steps_for_accuracy(eta: float, L: float, mu: float, b: float, r0_sq: float) -> int:
    """Static step count so that prox_gd returns a b-approximation, from the
    linear convergence of GD on the (mu+1/eta)-strongly-convex subproblem."""
    kappa = (L + 1.0 / eta) / (mu + 1.0 / eta)
    rate = 1.0 - 1.0 / kappa
    if b >= r0_sq:
        return 1
    return max(1, math.ceil(math.log(b / r0_sq) / math.log(rate)))
