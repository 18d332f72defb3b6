"""The paper's theorems as ONE queryable prediction layer.

Port of `repro.core.theory`:

* ``theory_grid(algo, problem, ...)`` — the hyperparameter grid the theorems
  prescribe for a concrete problem instance (measured mu / delta / sigma_*^2),
  which is what ``run_batch(..., stepsize="theory")`` resolves;
* ``predict_comm(algo, mu=..., delta=..., M=..., eps=...)`` — the predicted
  communication-steps-to-eps, with the paper's log factors and the Section-4.2
  accounting (2 per SPPM round; 3M init + 2 + 3pM per SVRP round; Catalyst
  re-pays the anchor init per stage), overlayable on the engine's measured
  ``comm_to_accuracy``;
* ``predict_comm_bytes`` — the same in wire bytes, priced by the port's
  channel layer (`core.channel.wire_vector_bytes`; a channel the port does
  not carry raises there).

Everything is plain float arithmetic on the measured constants.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

from repro_torch.core.catalyst import catalyst_inner_iterations, theorem3_gamma
from repro_torch.core.channel import wire_vector_bytes
from repro_torch.core.similarity import grad_noise_at
from repro_torch.core.sppm import theorem1_iterations, theorem1_stepsize
from repro_torch.core.svrp import theorem2_iterations, theorem2_stepsize


class ProblemConstants(NamedTuple):
    """The measured/exact constants every prediction is a function of."""

    mu: float  # strong convexity (Assumption 2)
    delta: float  # second-order similarity (Assumption 1)
    M: int  # number of clients
    sigma_star_sq: float  # gradient noise at the optimum (Theorem 1)
    r0_sq: float  # ||x0 - x_*||^2


def measure_constants(problem, x0=None, x_star=None) -> ProblemConstants:
    """Pull the theorem constants off a problem instance.

    Quadratics expose exact values (`similarity()`); statistical problems
    (logistic / DP-ERM) are measured at the optimum, exactly as the paper
    reports its L / delta numbers.
    """
    if x_star is None:
        x_star = problem.minimizer()
    if hasattr(problem, "similarity"):
        delta = float(problem.similarity())
    else:
        delta = float(problem.similarity_at(x_star))
    mu = float(problem.strong_convexity())
    sigma_star_sq = float(grad_noise_at(problem, x_star))
    if x0 is None:
        r0_sq = float((x_star * x_star).sum())  # x0 = 0 convention
    else:
        r0_sq = float(((x0 - x_star) ** 2).sum())
    return ProblemConstants(
        mu=mu, delta=delta, M=int(problem.num_clients),
        sigma_star_sq=sigma_star_sq, r0_sq=r0_sq,
    )


# ------------------------------------------------------------ per-algo entries
def _sppm_grid(c: ProblemConstants, eps: float) -> dict:
    return {"eta": theorem1_stepsize(c.sigma_star_sq, c.mu, eps)}


def _sppm_comm(c: ProblemConstants, eps: float) -> float:
    # 2 communication steps per round (x_k down, x_{k+1} up), no anchor.
    # Iteration counts floor at 1: the theorem bounds go nonpositive in the
    # degenerate already-converged regime r0_sq <= eps.
    return 2.0 * max(theorem1_iterations(c.sigma_star_sq, c.mu, eps, c.r0_sq), 1.0)


def _svrp_grid(c: ProblemConstants, eps: float) -> dict:
    del eps
    return {"eta": theorem2_stepsize(c.mu, c.delta), "p": 1.0 / c.M}


def _svrp_comm(c: ProblemConstants, eps: float) -> float:
    # Section 4.2: anchor init 3M, then E[comm/round] = 2 + 3 p M = 5 at p=1/M.
    K = max(theorem2_iterations(c.mu, c.delta, c.M, eps, c.r0_sq), 1.0)
    return 3.0 * c.M + 5.0 * K


def _minibatch_grid(c: ProblemConstants, eps: float) -> dict:
    del eps
    return {"eta": theorem2_stepsize(c.mu, c.delta), "p": 1.0 / c.M}


def _catalyzed_grid(c: ProblemConstants, eps: float) -> dict:
    del eps
    gamma = theorem3_gamma(c.mu, c.delta, c.M)
    return {
        "mu": c.mu,
        "gamma": gamma,
        "eta": theorem2_stepsize(c.mu + gamma, c.delta),
        "p": 1.0 / c.M,
    }


def _catalyzed_comm(c: ProblemConstants, eps: float) -> float:
    """Theorem 3's accelerated rate in the repo's accounting: S Catalyst
    stages (outer linear rate sqrt(q), q = mu/(mu+gamma)), each running T_A
    inner SVRP rounds on the gamma-conditioned surrogate and re-paying the
    3M anchor init at the stage boundary."""
    gamma = theorem3_gamma(c.mu, c.delta, c.M)
    q = c.mu / (c.mu + gamma)
    stages = math.ceil(
        max(1.0, math.log(max(c.r0_sq / eps, math.e)) / math.sqrt(q))
    )
    inner = catalyst_inner_iterations(c.mu, c.delta, c.M)
    return stages * (3.0 * c.M + 5.0 * inner)


class TheoryEntry(NamedTuple):
    """One algorithm's theorem-prescribed parameters and rate."""

    grid: Callable[[ProblemConstants, float], dict]
    comm: Callable[[ProblemConstants, float], float] | None


THEORY: dict[str, TheoryEntry] = {
    "sppm": TheoryEntry(_sppm_grid, _sppm_comm),
    "svrp": TheoryEntry(_svrp_grid, _svrp_comm),
    "svrp_minibatch": TheoryEntry(_minibatch_grid, None),
    "catalyzed_svrp": TheoryEntry(_catalyzed_grid, _catalyzed_comm),
}


def theory_grid(algo: str, problem, *, eps: float = 1e-6, x0=None, x_star=None,
                constants: ProblemConstants | None = None) -> dict:
    """The theorem-prescribed hyperparameter grid for `algo` on `problem` —
    the resolver behind ``run_batch(..., stepsize="theory")``.  Pass
    ``constants`` to skip the (minimizer-solving) measurement."""
    if algo not in THEORY:
        raise ValueError(
            f"no theory-prescribed stepsize for algo {algo!r}; "
            f"available: {sorted(THEORY)}"
        )
    c = constants if constants is not None else measure_constants(problem, x0, x_star)
    return THEORY[algo].grid(c, eps)


def predict_comm(
    algo: str,
    *,
    mu: float,
    delta: float,
    M: int,
    eps: float,
    sigma_star_sq: float = 1.0,
    r0_sq: float = 1.0,
) -> float:
    """Predicted communication steps to reach E||x - x_*||^2 <= eps, in the
    repo's Section-4.2 accounting (overlayable on measured comm axes)."""
    entry = THEORY.get(algo)
    if entry is None or entry.comm is None:
        raise ValueError(
            f"no communication prediction for algo {algo!r}; available: "
            f"{sorted(name for name, e in THEORY.items() if e.comm is not None)}"
        )
    c = ProblemConstants(mu=mu, delta=delta, M=M,
                         sigma_star_sq=sigma_star_sq, r0_sq=r0_sq)
    return entry.comm(c, eps)


def predict_comm_for(problem, algo: str, *, eps: float = 1e-6,
                     x0=None, x_star=None,
                     constants: ProblemConstants | None = None) -> float:
    """`predict_comm` with the constants measured off a problem instance."""
    c = constants if constants is not None else measure_constants(problem, x0, x_star)
    return predict_comm(
        algo, mu=c.mu, delta=c.delta, M=c.M, eps=eps,
        sigma_star_sq=c.sigma_star_sq, r0_sq=c.r0_sq,
    )


def predict_comm_bytes(
    algo: str,
    *,
    mu: float,
    delta: float,
    M: int,
    eps: float,
    dim: int,
    sigma_star_sq: float = 1.0,
    r0_sq: float = 1.0,
    channel: str | None = None,
    itemsize: int = 4,
) -> float:
    """Predicted BYTES on the wire to reach eps: `predict_comm` (Section-4.2
    vector-exchange counts) x the channel's static wire size for one
    d-vector.  This is exact relative to the engine's measured ledger — every
    counted exchange is one d-vector priced at the same
    `channel.wire_vector_bytes` the entry points use — so predictions overlay
    directly on `BatchResult.bytes_to_accuracy` axes."""
    steps = predict_comm(
        algo, mu=mu, delta=delta, M=M, eps=eps,
        sigma_star_sq=sigma_star_sq, r0_sq=r0_sq,
    )
    return steps * wire_vector_bytes(channel, dim, itemsize)


def predict_comm_bytes_for(problem, algo: str, *, eps: float = 1e-6,
                           x0=None, x_star=None,
                           constants: ProblemConstants | None = None,
                           channel: str | None = None) -> float:
    """`predict_comm_bytes` with constants measured off a problem instance
    (dim and dtype width come from the problem itself)."""
    c = constants if constants is not None else measure_constants(problem, x0, x_star)
    itemsize = 4
    for attr in ("A", "Z"):
        if hasattr(problem, attr):
            itemsize = getattr(problem, attr).element_size()
            break
    return predict_comm_bytes(
        algo, mu=c.mu, delta=c.delta, M=c.M, eps=eps, dim=int(problem.dim),
        sigma_star_sq=c.sigma_star_sq, r0_sq=c.r0_sq,
        channel=channel, itemsize=itemsize,
    )
