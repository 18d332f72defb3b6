"""Analytic FLOPs-per-round / HBM-bytes-per-round for every `ALGOS` entry.

Port of `repro.core.flops`: host numpy only, so the port keeps its own copy
and its counts equal the reference's exactly (`tests/test_torch_flops.py`).
The paper's Section 4.2 counts communicated *vectors*; the comm-channel
layer prices them in wire bytes.  This module is the compute-side
counterpart: closed-form FLOP and HBM-byte counts per round, derived from
problem shapes, per (algorithm, prox solver, channel) — the numbers behind
the serve layer's ``flops`` stats (`serve.FedSession.flops`,
`serve.FedRoundServer`'s achieved FLOP/s).

Structure mirrors the byte ledger (`experiments.runner.ledger_bytes`): each
algorithm's round decomposes into

    init     — one-time work (SVRP's comm0 full gradient; Catalyst repeats it
               once per stage),
    base     — work every round performs unconditionally,
    refresh  — work performed only on Bernoulli(p) anchor-refresh rounds.

Because the comm-vector trajectory increments by exactly `comm_base` on a
plain round and `comm_base + comm_refresh` on a refresh round, the *exact*
number of refreshes that occurred is recoverable from the recorded comm
trajectory — so `ledger_flops` (like `ledger_bytes`) is exact per trial, not
an expectation.  `round_cost` gives the p-expected per-round cost for
benchmarks that only know p.

Conventions:

  * a multiply-add counts as 2 FLOPs (matvec on (d, d) = 2 d^2);
  * iterative solvers with a *fixed* trip count (gd prox, newton-fixed25,
    FISTA) are exact; guarded solvers with early exit (newton, newton-cg,
    logistic "exact") are counted at their declared iteration CEILING and
    flagged `ceiling=True` in the detail dict — an MFU computed from them
    OVERSTATES (and can exceed 1 when early exit cuts most iterations);
  * the fused paths (the Hopper kernels) compute the same math as the
    registry solvers, so their analytic FLOPs are identical;
  * channel codecs charge per communicated vector (`quant8` ~6 d for block
    max/scale/round + dequant + error-feedback add/sub; `cast*` ~d; identity
    0), multiplied by the same comm counts the byte ledger uses;
  * HBM bytes are a streaming lower bound (operands + results touched once).

The federated LM's forward cost is `launch.roofline._fwd_cost` over the
port's `configs.base.ModelConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple

import numpy as np

__all__ = [
    "PrimCosts",
    "RoundModel",
    "RoundCost",
    "channel_flops_per_vector",
    "problem_prims",
    "prox_cost",
    "round_model",
    "round_cost",
    "sweep_flops",
    "ledger_flops",
    "flops_at",
    "tick_flops",
]

_HELP = "see repro_torch.core.flops for the supported set"


# --------------------------------------------------------------------------
#  Primitive costs per problem family
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrimCosts:
    """Per-problem primitive costs (one client unless noted).

    All *_flops are FLOPs, *_bytes are streaming HBM bytes (operands +
    results touched once).  `hess_flops` builds the prox-subproblem Hessian
    A_m + I/eta (quadratic: gather + axpy; logistic: the (n, d) weighted
    Gram).  `hvp_flops` is one Hessian-vector product via the linearized
    gradient (newton-cg's inner loop).
    """

    family: str
    dim: int
    num_clients: int
    itemsize: int
    grad_flops: float
    grad_bytes: float
    hess_flops: float
    hess_bytes: float
    hvp_flops: float
    # What `problem.full_grad` EXECUTES, not the federated M-client sum: the
    # synthetic quadratic hoists the client mean to `A_bar @ x - b_bar` at
    # construction (one matvec), while logistic/fed_lm genuinely touch every
    # client's data.  MFU divides analytic FLOPs by measured wall-clock, so
    # crediting M matvecs the engine never runs would inflate it; the
    # federated-work equivalent is recorded in `detail`
    # (the reference's docs/PERFORMANCE.md#flop-model).
    full_grad_flops: float
    full_grad_bytes: float
    detail: Mapping[str, Any]

    @property
    def federated_full_grad_flops(self) -> float:
        # M client grads + running mean ((M + 1) d adds/scales) — the cost a
        # real deployment pays for the anchor refresh, whatever the simulator
        # hoists.  Informational (detail/docs); the model counts executed work.
        return self.num_clients * self.grad_flops + (self.num_clients + 1) * self.dim


def problem_prims(problem) -> PrimCosts:
    """Dispatch a problem instance to its primitive cost model.

    DP wrappers are subclasses of their base problems and inherit the base
    counts: `DPQuadraticProblem` folds clip + noise into `b` at construction
    (zero per-round overhead, noted in detail); `DPLogisticProblem` adds its
    `dp_shift` output-perturbation vector inside every `grad` call (+d).
    """
    try:
        d = int(problem.dim)
        M = int(problem.num_clients)
    except AttributeError:
        raise ValueError(
            f"no FLOP model for problem type {type(problem).__name__!r}; {_HELP}"
        ) from None

    if hasattr(problem, "A") and getattr(problem.A, "ndim", 0) == 3:
        s = int(problem.A.dtype.itemsize)
        dp = hasattr(problem, "dp_sigma")
        # grad = A_m @ x - b_m: matvec (2 d^2) + subtract (d).  full_grad is
        # the HOISTED mean `A_bar @ x - b_bar` (quadratic.py) — one matvec,
        # not M; the federated-work equivalent goes in detail.
        grad_f = 2.0 * d * d + d
        fed = M * grad_f + (M + 1) * d
        return PrimCosts(
            family="quadratic", dim=d, num_clients=M, itemsize=s,
            grad_flops=grad_f,
            grad_bytes=(d * d + 3 * d) * s,
            hess_flops=float(d * d + d),          # eye + eta * A_m
            hess_bytes=2.0 * d * d * s,
            hvp_flops=2.0 * d * d + 2 * d,        # A_m @ v + v / eta
            full_grad_flops=grad_f,
            full_grad_bytes=(d * d + 3 * d) * s,
            detail={
                "full_grad_hoisted": True,
                "federated_full_grad_flops": fed,
                **({"dp": dp, "dp_per_round_extra": 0.0} if dp else {}),
            },
        )

    if hasattr(problem, "Z") and getattr(problem.Z, "ndim", 0) == 3:
        n = int(problem.Z.shape[1])
        s = int(problem.Z.dtype.itemsize)
        dp_extra = float(d) if hasattr(problem, "dp_shift") else 0.0
        # grad = -(A^T sigmoid(-A x)) / n + lam x: two (n, d) matvecs (4 n d),
        # sigmoid ~4 flops/row, scale + axpy ~3 d (+d for the DP shift).
        return PrimCosts(
            family="logistic", dim=d, num_clients=M, itemsize=s,
            grad_flops=4.0 * n * d + 4 * n + 3 * d + dp_extra,
            grad_bytes=(n * d + 2 * n + 3 * d) * s,
            # (A * s[:, None])^T @ A / n + (lam + 1/eta) I: weighted Gram
            # (2 n d^2) + row weights (2 n d + 5 n) + diag add (d).
            hess_flops=2.0 * n * d * d + 2.0 * n * d + 5 * n + d,
            hess_bytes=(2 * n * d + d * d) * s,
            hvp_flops=4.0 * n * d + 2 * n + 3 * d,
            # full_grad is the two (M, n, d) einsums (logistic.py): it really
            # touches every client's data — M client grads + the mean.
            full_grad_flops=M * (4.0 * n * d + 4 * n + 3 * d + dp_extra) + (M + 1) * d,
            full_grad_bytes=M * (n * d + 2 * n + 3 * d) * s + 2 * d * s,
            detail={"n_per_client": n, "dp_per_grad_extra": dp_extra},
        )

    if hasattr(problem, "tokens") and hasattr(problem, "cfg"):
        # FedLMProblem: transformer clients.  Reuse the dry-run launch
        # model's forward-pass cost; grad = fwd + bwd (2x) + remat (1x).
        from repro_torch.launch.roofline import _fwd_cost

        M_, batch, seq = (int(v) for v in problem.tokens.shape)
        f1, b1, det = _fwd_cost(problem.cfg, float(batch) * seq, batch, seq, seq / 2.0)
        P = int(problem.num_params)
        return PrimCosts(
            family="fed_lm", dim=P, num_clients=M_,
            itemsize=4,
            grad_flops=4.0 * f1, grad_bytes=4.0 * b1,
            hess_flops=float("nan"), hess_bytes=float("nan"),
            hvp_flops=float("nan"),
            full_grad_flops=M_ * 4.0 * f1 + (M_ + 1) * P,
            full_grad_bytes=M_ * 4.0 * b1 + 2.0 * 4 * P,
            detail={"fwd": det, "batch": batch, "seq": seq},
        )

    raise ValueError(
        f"no FLOP model for problem type {type(problem).__name__!r}; {_HELP}"
    )


# --------------------------------------------------------------------------
#  Prox solver costs (per prox call, one client)
# --------------------------------------------------------------------------
def prox_cost(prims: PrimCosts, solver: str, prox_steps: int) -> tuple[float, float, dict]:
    """(flops, hbm_bytes, detail) of ONE prox_{eta f_m}(z) call.

    Iteration counts come from the solver's declared statics (`prox_steps`
    for gd/newton*, `cg_steps=25` hardwired in `prox_newton_cg`); guarded
    solvers are ceilings (early exit at tol), flagged in detail.
    """
    d, s = prims.dim, prims.itemsize
    if solver == "exact":
        if prims.family == "quadratic":
            # (I + eta A)^{-1}(z + eta b): build (d^2 + d) + rhs (2 d) +
            # LU solve (2/3 d^3 + 2 d^2).
            f = (2.0 / 3.0) * d**3 + 3.0 * d * d + 3 * d
            return f, (d * d + 4 * d) * s, {"ceiling": False}
        if prims.family == "logistic":
            # problem.prox == guarded Newton, max_steps=50 (logistic.py).
            return prox_cost(prims, "newton", 50)
        raise ValueError(f"no 'exact' prox model for family {prims.family!r}; {_HELP}")
    if solver == "spectral":
        if prims.family != "quadratic":
            raise ValueError(f"'spectral' prox is quadratic-only; {_HELP}")
        # Q ((Q^T (z + eta b)) / (1 + eta lam)): two matvecs + diag ops.
        # The O(M d^3) eigh runs ONCE per sweep (hoisted out of the scan);
        # reported separately as hoisted_prepare_flops, not per round.
        f = 4.0 * d * d + 5 * d
        return f, (2 * d * d + 5 * d) * s, {
            "ceiling": False,
            "hoisted_prepare_flops": 9.0 * prims.num_clients * d**3,
        }
    if solver == "gd":
        # prox_gd: EXACT fixed trip count (prox_steps steps); per iter
        # y <- y - beta (grad(y) + (y - z)/eta) ~ grad + 5 d elementwise.
        # The fused kernel (K1's loop form) computes the identical update
        # (equivalence tests hold it to the registry), so fused FLOPs are identical.
        f = prox_steps * (prims.grad_flops + 5 * d)
        return f, prox_steps * (prims.grad_bytes + 4 * d * s), {
            "ceiling": False, "iters": prox_steps, "fused_identical": True,
        }
    if solver in ("newton", "newton_cg", "newton-cg"):
        if solver == "newton":
            # guarded Newton CEILING: per iter hess + dense solve + value/grad
            # for the backtrack (~2 extra grads) + vec ops.
            per = (
                prims.hess_flops + (2.0 / 3.0) * d**3 + 2.0 * d * d
                + 3.0 * prims.grad_flops + 6 * d
            )
            steps = prox_steps
            per_bytes = prims.hess_bytes + d * d * s + 3 * prims.grad_bytes
        else:
            # newton-cg CEILING: per outer, one linearization (~1 grad) + 25 CG
            # iterations of one hvp + ~10 d vector work + backtrack grads.
            cg = 25
            per = prims.grad_flops + cg * (prims.hvp_flops + 10 * d) + 2.0 * prims.grad_flops
            steps = prox_steps
            per_bytes = prims.grad_bytes + cg * (prims.grad_bytes + 6 * d * s)
        return steps * per, steps * per_bytes, {"ceiling": True, "iters": steps}
    if solver == "newton-fixed25":
        # legacy bench-only solver: exactly 25 raw Newton steps, no guard.
        per = prims.hess_flops + (2.0 / 3.0) * d**3 + 2.0 * d * d + prims.grad_flops
        return 25 * per, 25 * (prims.hess_bytes + prims.grad_bytes + d * d * s), {
            "ceiling": False, "iters": 25,
        }
    raise ValueError(f"no FLOP model for prox solver {solver!r}; {_HELP}")


def channel_flops_per_vector(channel: str | None, dim: int) -> float:
    """Codec FLOPs per communicated vector (same counting unit as the byte
    ledger).  quant8: block max + scale + round + dequant + error-feedback
    add/subtract ~6/elt; cast/cast16: one convert/elt; identity: 0."""
    if channel in (None, "identity"):
        return 0.0
    if channel == "quant8":
        return 6.0 * dim
    if channel in ("cast", "cast16"):
        return float(dim)
    raise ValueError(f"no FLOP model for channel {channel!r}; {_HELP}")


# --------------------------------------------------------------------------
#  Per-algorithm round models
# --------------------------------------------------------------------------
class RoundModel(NamedTuple):
    """Linear model of one algorithm's cumulative work.

    cumulative_flops(k rounds, r refreshes, i inits)
        = i * init_flops + k * base_flops + r * refresh_flops
    and identically for bytes and comm vectors — which makes r exactly
    recoverable from the comm trajectory (see `ledger_flops`).
    `stage_rounds > 0` marks Catalyst: one init per `stage_rounds` rounds.
    """

    algo: str
    init_flops: float
    base_flops: float
    refresh_flops: float
    init_bytes: float
    base_bytes: float
    refresh_bytes: float
    comm_init: int
    comm_base: int
    comm_refresh: int
    stage_rounds: int
    detail: Mapping[str, Any]


class RoundCost(NamedTuple):
    """Expected per-round cost (base + p * refresh), channel included."""

    flops: float
    hbm_bytes: float
    detail: Mapping[str, Any]


def _dist_flops(d: int) -> float:
    return 3.0 * d  # ||x - x_star||^2: subtract + square + reduce


def round_model(algo: str, problem, **static: Any) -> RoundModel:
    """Build the RoundModel for `algo` on `problem`.

    `static` accepts the algorithm's resolved static config (unknown keys —
    e.g. `num_steps`, `prox_R` — are ignored, so a session's `cfg` mapping
    can be passed wholesale).  Comm counts match core/rounds.py,
    core/baselines.py, core/composite.py exactly; tests/test_flops.py holds
    the reconstruction `ledger_flops` consistent with them.
    """
    pr = problem_prims(problem)
    d, M, s = pr.dim, pr.num_clients, pr.itemsize
    solver = static.get("prox_solver", "exact")
    prox_steps = int(static.get("prox_steps", 50))
    channel = static.get("channel")
    ch = channel_flops_per_vector(channel, d)
    vec = d * s  # HBM bytes of one model vector

    def mk(init_f, base_f, refresh_f, init_b, base_b, refresh_b,
           c_init, c_base, c_refresh, stage_rounds=0, **detail):
        return RoundModel(
            algo=algo,
            init_flops=init_f + ch * c_init,
            base_flops=base_f + ch * c_base + _dist_flops(d),
            refresh_flops=refresh_f + ch * c_refresh,
            init_bytes=init_b, base_bytes=base_b + 3 * vec,
            refresh_bytes=refresh_b,
            comm_init=c_init, comm_base=c_base, comm_refresh=c_refresh,
            stage_rounds=stage_rounds,
            detail={"family": pr.family, "channel": channel,
                    "channel_flops_per_vector": ch, **detail},
        )

    if algo in ("sppm", "svrp", "svrp_minibatch", "catalyzed_svrp", "composite"):
        if algo == "composite":
            # joint_prox_fista: EXACT prox_steps (default 80) FISTA iterations,
            # each one grad + prox_R (~2 d model) + extrapolation (~6 d).
            fista = int(static.get("prox_steps", 80))
            pf = fista * (pr.grad_flops + 8.0 * d)
            pb = fista * (pr.grad_bytes + 5 * vec)
            pdet = {"solver": "fista", "ceiling": False, "iters": fista}
        else:
            pf, pb, pdet = prox_cost(pr, solver, prox_steps)
            pdet = {"solver": solver, **pdet}
        if algo == "sppm":
            # x <- prox(z = x); comm +2 (down x, up prox result).
            return mk(0.0, pf, 0.0, 0.0, pb, 0.0, 0, 2, 0, **pdet)
        refresh_f = pr.full_grad_flops + d  # + select(new anchor)
        refresh_b = pr.full_grad_bytes + 2 * vec
        if algo == "svrp_minibatch":
            b = int(static["batch_clients"])
            base_f = b * (pr.grad_flops + pf) + (b + 1) * d + 4.0 * d
            base_b = b * (pr.grad_bytes + pb) + 4 * vec
            return mk(pr.full_grad_flops, base_f, refresh_f,
                      pr.full_grad_bytes, base_b, refresh_b,
                      3 * M, 2 * b, 3 * M, batch_clients=b, **pdet)
        # svrp / catalyzed / composite round body: one control variate grad,
        # z = x - eta (g_m(x) - gbar) (~4 d), one prox.
        base_f = pr.grad_flops + 4.0 * d + pf
        base_b = pr.grad_bytes + 4 * vec + pb
        if algo == "catalyzed_svrp":
            # shifted-problem grad adds gamma (x - anchor): +3 d per grad
            # site; one full-grad init per stage of inner_steps rounds.
            inner = int(static["inner_steps"])
            return mk(pr.full_grad_flops + 3.0 * M * d, base_f + 6.0 * d,
                      refresh_f + 3.0 * M * d,
                      pr.full_grad_bytes, base_b + 2 * vec, refresh_b,
                      3 * M, 2, 3 * M, stage_rounds=inner, **pdet)
        return mk(pr.full_grad_flops, base_f, refresh_f,
                  pr.full_grad_bytes, base_b, refresh_b, 3 * M, 2, 3 * M, **pdet)

    if algo == "deep_svrp":
        # every round: all M clients run `local_steps` Algorithm-7 GD
        # iterations seeded from one variate grad each; client mean.
        T = int(static.get("local_steps", 4))
        base_f = M * (pr.grad_flops + T * (pr.grad_flops + 6.0 * d)) + (M + 1) * d + 4.0 * d
        base_b = M * (1 + T) * pr.grad_bytes + (M + 2) * vec
        return mk(pr.full_grad_flops, base_f, pr.full_grad_flops + d,
                  pr.full_grad_bytes, base_b, pr.full_grad_bytes + 2 * vec,
                  3 * M, 2 * M, 2 * M, solver="local_gd", iters=T, ceiling=False)

    if algo == "sgd":
        return mk(0.0, pr.grad_flops + 2.0 * d, 0.0,
                  0.0, pr.grad_bytes + 2 * vec, 0.0, 0, 2, 0)
    if algo == "svrg":
        base_f = 2.0 * pr.grad_flops + 6.0 * d
        return mk(pr.full_grad_flops, base_f, pr.full_grad_flops + d,
                  pr.full_grad_bytes, 2 * pr.grad_bytes + 4 * vec,
                  pr.full_grad_bytes + 2 * vec, 3 * M, 2, 3 * M)
    if algo == "scaffold":
        T = int(static.get("local_steps", 1))
        base_f = T * (pr.grad_flops + 4.0 * d) + 8.0 * d
        base_b = T * (pr.grad_bytes + 3 * vec) + 4 * vec
        return mk(0.0, base_f, 0.0, 0.0, base_b, 0.0, 0, 2, 0, iters=T)
    if algo in ("dane", "acc_extragradient"):
        # surrogate minimization (core/baselines._surrogate_min): quadratic
        # closed-form solve; logistic guarded Newton max_steps=40 (ceiling).
        if pr.family == "quadratic":
            sur = (2.0 / 3.0) * d**3 + 3.0 * d * d + 4 * d
            sur_b, sdet = (d * d + 4 * d) * s, {"ceiling": False}
        else:
            sur, sur_b, sdet = prox_cost(pr, "newton", 40)
        if algo == "dane":
            base_f = pr.full_grad_flops + pr.grad_flops + sur + 4.0 * d
            base_b = pr.full_grad_bytes + pr.grad_bytes + sur_b
            return mk(0.0, base_f, 0.0, 0.0, base_b, 0.0, 0, 2 * M + 2, 0,
                      surrogate="dane", **sdet)
        base_f = 2.0 * (pr.full_grad_flops + pr.grad_flops + sur) + 10.0 * d
        base_b = 2.0 * (pr.full_grad_bytes + pr.grad_bytes + sur_b)
        return mk(0.0, base_f, 0.0, 0.0, base_b, 0.0, 0, 4 * M + 2, 0,
                  surrogate="acc_eg", **sdet)

    raise ValueError(f"no FLOP model for algorithm {algo!r}; {_HELP}")


# --------------------------------------------------------------------------
#  Expected / exact evaluation
# --------------------------------------------------------------------------
def round_cost(algo: str, problem, *, p: float = 0.0, **static: Any) -> RoundCost:
    """Expected cost of ONE round: base + p * refresh (init excluded)."""
    m = round_model(algo, problem, **static)
    return RoundCost(
        flops=m.base_flops + p * m.refresh_flops,
        hbm_bytes=m.base_bytes + p * m.refresh_bytes,
        detail=dict(m.detail),
    )


def sweep_flops(algo: str, problem, *, num_rounds: int, num_trials: int = 1,
                p: float = 0.0, include_init: bool = True, **static: Any) -> float:
    """Expected total FLOPs of a sweep: per-trial init + rounds, plus any
    once-per-sweep hoisted preparation (spectral eigh) counted ONCE."""
    m = round_model(algo, problem, **static)
    stages = (
        -(-num_rounds // m.stage_rounds) if m.stage_rounds else 1
    )
    per_trial = num_rounds * (m.base_flops + p * m.refresh_flops)
    if include_init:
        per_trial += stages * m.init_flops
    total = num_trials * per_trial
    total += float(m.detail.get("hoisted_prepare_flops", 0.0))
    return total


def flops_at(model: RoundModel, k: np.ndarray, comm: np.ndarray) -> np.ndarray:
    """EXACT cumulative FLOPs after round k given the cumulative comm-vector
    trajectory (broadcasting; k is 1-based round index).

    Inverts the comm linear model: with i(k) inits by round k (1, or
    ceil(k / stage_rounds) for Catalyst),

        refreshes(k) = (comm(k) - i(k) comm_init - k comm_base) / comm_refresh
    """
    k = np.asarray(k, dtype=np.float64)
    comm = np.asarray(comm, dtype=np.float64)
    if model.stage_rounds:
        inits = np.ceil(k / model.stage_rounds)
    else:
        inits = np.where(k > 0, 1.0, 0.0) if model.comm_init else np.zeros_like(k)
    if model.comm_refresh:
        refreshes = (comm - inits * model.comm_init - k * model.comm_base) / model.comm_refresh
        refreshes = np.maximum(np.round(refreshes), 0.0)
    else:
        refreshes = np.zeros_like(comm)
    return (
        inits * model.init_flops
        + k * model.base_flops
        + refreshes * model.refresh_flops
    )


def ledger_flops(algo: str, cfg: Mapping[str, Any], problem, comm) -> np.ndarray:
    """Cumulative-FLOPs trajectory for a recorded comm trajectory — the
    compute-side mirror of `runner.ledger_bytes` (exact, not expected).

    `comm` is the cumulative comm-vector array, shape (..., K) with round k
    at index k-1 (as stored on RunResult / FedSession.comm)."""
    model = round_model(algo, problem, **{k: v for k, v in cfg.items() if k != "prox_R"})
    comm = np.asarray(comm)
    k = np.arange(1, comm.shape[-1] + 1, dtype=np.float64)
    return flops_at(model, k, comm)


def tick_flops(model: RoundModel, delta_comm: float, rounds: float,
               prev_rounds: float = 0.0) -> float:
    """EXACT FLOPs of an incremental step of `rounds` rounds whose comm
    counter advanced by `delta_comm` vectors (serve-layer per-tick
    accounting; init FLOPs charged when a Catalyst stage boundary is
    crossed, and at the first rounds for init-carrying algorithms)."""
    if model.stage_rounds:
        inits = np.ceil((prev_rounds + rounds) / model.stage_rounds) - np.ceil(
            prev_rounds / model.stage_rounds
        )
    else:
        inits = 1.0 if (model.comm_init and prev_rounds == 0 and rounds > 0) else 0.0
    delta = delta_comm - inits * model.comm_init
    if model.comm_refresh:
        refreshes = max(round((delta - rounds * model.comm_base) / model.comm_refresh), 0)
    else:
        refreshes = 0.0
    return float(
        inits * model.init_flops
        + rounds * model.base_flops
        + refreshes * model.refresh_flops
    )
