"""Round-step substrate layer: every algorithm defined ONCE, run on three substrates.

Port of `repro.core.rounds`.  Each algorithm of the SPPM/SVRP family is one
``RoundDef``:

* ``init(ops, x0) -> state``          — round-0 state (iterate, anchor,
  cached anchor gradient, communication counter, channel state);
* ``round(ops, state, k) -> (state, (dist_sq, comm))`` — communication round
  ``k``, written against the sampling / prox-oracle / anchor interface
  ``RoundOps``.

``RoundOps`` works over LANES: state is ``S + (d,)`` with ``S = ()`` for one
trial (the reference's ``batched=False``) or ``S = (B,)`` for a sweep, and
the same round code serves both.  Where the reference draws from PRNG keys
inside the round, the port reads round ``k`` of a `core.draws.Draws` record
(one trial's record for ``S = ()``).  Three substrates bind it:

==========  ================================================================
substrate   execution
==========  ================================================================
sequential  one trial, ``S = ()``: the ``*_scan`` drivers of
            ``core/sppm.py``, ``core/svrp.py`` and ``core/minibatch.py``
            through `make_registry_ops` and the registry prox solver.
registry    the engine's default (``run_batch(fused=False)``): the same
            binding over ``S = (B,)`` lanes (`registry_batched_scan`); every
            registry solver (exact, spectral, gd, newton, newton-cg) takes
            per-lane ``eta`` and smoothness.
fused       ``(B, d)`` lanes with the Algorithm-7 local solves through the
            batched Hopper kernels (`kernels.quadratic_prox_gd_batched` for
            quadratic problems, `kernels.logistic_prox_gd_indexed` for
            logistic ones, each a whole solve in one launch, and
            `kernels.prox_update_batched` a launch per GD step for
            Catalyst): `batched_scan`.
==========  ================================================================

Catalyst's outer recurrence (`catalyst_step_def`) runs the shared svrp round
on each stage's shifted oracles, on any substrate: the fused one overrides
the gradients and solves through the elementwise kernel; the sequential and
registry ones solve on the problem's per-lane shifted subproblem
(``problem.shifted_lanes``).

Batch-aware anchor refresh: the reference gates the full-gradient recompute
behind one ``lax.cond(jnp.any(c))`` per round (``lax.cond(c)`` for one
trial).  Here the coins are known before the first round, so the host
already holds the per-round "any trial refreshes" mask (`Draws.refresh`) and
skips the recompute on rounds where no trial refreshes, without waiting on
the device; the per-trial selection ``where(c, full_grad(w'), gbar)`` is
unchanged.

Communication accounting follows Section 4.2: one vector exchange
server<->client = 1 step; the initial anchor setup = 3M; a refresh re-runs
it.  ``comm`` keeps the reference's dtypes under x64: int64 for sppm, int32
for the refresh-bearing rounds (the reference's ``c.astype(int32)``
increment fixes their counter to int32).

DeepSVRP's round (``deep_svrp``) is full participation: every client runs
``local_steps`` Algorithm-7 GD steps from the broadcast iterate each round,
and the server averages them.  Its local solver is ONE binding
(`deep_local_prox_gd`) that the sequential, registry and fused substrates
share: each GD step is one K1 launch (`kernels.prox_update_batched`) over
the lanes x M rows, with the per-row gradients from ``problem.grad`` (a
quadratic's batched matvec, or `problems.fed_lm.FedLMProblem`'s model
gradients through K4 / K4b).  A problem with a ``metric`` (the federated
LM) reports it per lane in place of the squared distance.

`local_prox_gd_tree` is DeepSVRP's local solver over a parameter tree, the
loop the DeepSVRP round (`core.deep`) and the train step
(`launch.steps.make_svrp_train_step`) run on every cohort.

Each binding is also an incrementally steppable `core.types.StepDef`
(`registry_step_def`, `catalyst_step_def`): the online engine
(`repro_torch.serve`) steps it a chunk at a time over the record drawn for
the whole horizon, and `registry_pool_step_def` binds several tenants'
same-shaped quadratic sweeps as one lane batch (a session pool's tick).
The streaming server binds `core.draws.ResidentDraws` in place of a record:
its sampling over the resident clients is a draw source, not a callback.

The fourth substrate, client-sharded (`ClientShardedOps`,
`client_sharded_scan`, `client_sharded_step_def`), lays the CLIENT axis over
the ranks of a process group (`launch.mesh`): each rank holds a contiguous
block of the clients and runs the same round definitions, with one
`all_reduce` a round and one a refresh event (see its section below).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.channel import get_channel
from repro_torch.core.draws import Draws, concat_trials
from repro_torch.core.types import RunResult, StepDef, scan_step_def
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_zeros_like


class RoundDef(NamedTuple):
    """One algorithm as an (init, round) pair over the substrate interface."""

    name: str
    init: Callable  # (ops, x0) -> state
    round: Callable  # (ops, state, k) -> (state, (dist_sq, comm))


class RoundOps:
    """Substrate primitives of one binding over lanes ``S``.

    ``S`` is ``(B,)`` for a batched `Draws` record of B trials and ``()``
    for one trial's record.  The local prox solve is injected by the caller:
    ``prox(m, z)`` for single-client rounds (sppm/svrp), ``cohort_prox(ms,
    z)`` for minibatch cohorts, ``local_prox_gd(z, x)`` for DeepSVRP's
    full-participation rows.  ``grad``/``full_grad`` overrides replace the
    problem's oracles (the fused Catalyst's per-trial shifted gradients)."""

    def __init__(
        self,
        problem,
        hp,
        x_star: torch.Tensor,
        dtype: torch.dtype,
        *,
        draws: Draws,
        prox: Callable | None = None,
        cohort_prox: Callable | None = None,
        cohort_size: int | None = None,
        grad: Callable | None = None,
        full_grad: Callable | None = None,
        local_prox_gd: Callable | None = None,
        channel=None,
    ):
        self.problem = problem
        self.hp = hp
        self.x_star = x_star
        self.dtype = dtype
        self.device = x_star.device
        self.lanes = draws.lanes
        self.M = problem.num_clients
        self.draws = draws
        self.channel = get_channel(channel)
        self.prox = prox
        self.cohort_prox = cohort_prox
        self.cohort_size = cohort_size
        self.local_prox_gd = local_prox_gd
        self._grad = problem.grad
        self._full_grad = problem.full_grad
        self.oracle_overridden = grad is not None or full_grad is not None
        if grad is not None:
            self.grad = grad
        if full_grad is not None:
            self.full_grad = full_grad

    # ---------------------------------------------------------------- draws
    def uniform_client(self, k: int) -> torch.Tensor:
        return self.draws.clients[k]

    def sample_cohort(self, k: int) -> torch.Tensor:
        """``cohort_size`` clients without replacement (minibatch SVRP)."""
        return self.draws.clients[k]

    def bernoulli(self, k: int) -> torch.Tensor:
        return self.draws.coins[k]

    def all_clients(self) -> torch.Tensor:
        """Every client, in every lane: ``S + (M,)`` (DeepSVRP's full
        participation draws no client)."""
        return torch.arange(self.M, device=self.device).expand(self.lanes + (self.M,))

    # ------------------------------------------------------------- oracles
    def grad(self, m, y):
        return self._grad(m, y)

    def full_grad(self, w):
        return self._full_grad(w)

    def cohort_grad(self, ms, y):
        """Per-cohort-client gradients at the shared iterate: S + (b, d)."""
        if self.oracle_overridden:
            raise NotImplementedError(
                "cohort_grad does not support substrate-level oracle overrides"
            )
        return self._grad(ms, y[..., None, :].expand(ms.shape + y.shape[-1:]))

    def init_full_grad(self, x0):
        """Round-0 anchor gradient for a trial-SHARED ``x0``, computed once and
        tiled to per-trial state."""
        return self.tile(self._full_grad(x0))

    def refresh_grad(self, k: int, c, w_next, gbar):
        """Anchor-gradient refresh: the full gradient is paid only on rounds
        where some trial refreshes (host mask), selected per trial."""
        if not self.draws.refresh[k]:
            return gbar
        return torch.where(c.unsqueeze(-1), self.full_grad(w_next), gbar)

    # ------------------------------------------------------- shape algebra
    def tile(self, v):
        """Trial-shared array -> per-trial state (a contiguous copy per lane)."""
        return v.expand(self.lanes + v.shape).contiguous()

    def vec(self, h):
        """Per-trial scalar hparam as a multiplier for ``S + (d,)`` state."""
        h = torch.as_tensor(h, dtype=self.dtype, device=self.device)
        return h.broadcast_to(self.lanes).unsqueeze(-1)

    def cvec(self, h):
        """Like ``vec`` but broadcasting against ``S + (b, d)`` cohort arrays."""
        return self.vec(h).unsqueeze(-1)

    def expand(self, v):
        """Add the cohort axis: S + (d,) -> S + (1, d)."""
        return v[..., None, :]

    def where_vec(self, c, a, b):
        return torch.where(c.unsqueeze(-1), a, b)

    def as_count(self, c):
        return c.to(torch.int32)

    def comm0(self, n: int, dtype: torch.dtype = torch.int64):
        return torch.full(self.lanes, n, dtype=dtype, device=self.device)

    # ------------------------------------------------------------- channel
    def chan_init(self, xB):
        return self.channel.init_state(xB)

    def chan_down(self, ch, x):
        return self.channel.down(ch, x)

    def chan_up(self, v):
        return self.channel.up(v)

    def chan_bcast(self, v):
        return self.channel.bcast(v)

    def client_mean(self, y):
        """Mean over the client axis of full-participation rows: S + (M, d) -> S + (d,)."""
        return y.mean(dim=-2)

    def dist_sq(self, x):
        """Squared distance to x_star per lane; a problem with a ``metric``
        (no computable minimizer: the federated LM's mean loss) reports
        that, per lane, instead."""
        metric = getattr(self.problem, "metric", None)
        if metric is not None:
            return metric(x)
        return ((x - self.x_star) ** 2).sum(-1)


def round_step_def(rdef: RoundDef, ops: RoundOps, x0) -> StepDef:
    """One definition on one binding as a `StepDef`."""
    return StepDef(init=lambda: rdef.init(ops, x0), step=lambda s, k: rdef.round(ops, s, k),
                   final=lambda s: s[0])


def scan_rounds(rdef: RoundDef, ops: RoundOps, x0, num_steps: int) -> RunResult:
    """Execute ``num_steps`` rounds of one definition on one binding."""
    return scan_step_def(round_step_def(rdef, ops, x0), num_steps)


# ============================================================ round definitions


def _sppm_init(ops: RoundOps, x0):
    xB = ops.tile(x0)
    return (xB, ops.comm0(0), ops.chan_init(xB))


def _sppm_round(ops: RoundOps, s, k):
    x, comm, ch = s
    m = ops.uniform_client(k)
    ch, x_d = ops.chan_down(ch, x)
    x_next = ops.chan_up(ops.prox(m, x_d))
    comm = comm + 2  # server -> client (x_k), client -> server (x_{k+1})
    return (x_next, comm, ch), (ops.dist_sq(x_next), comm)


def _svrp_init(ops: RoundOps, x0):
    xB = ops.tile(x0)
    if ops.oracle_overridden:
        gbar = ops.full_grad(xB)  # the override sees per-trial state
    else:
        gbar = ops.init_full_grad(x0)  # x0 is trial-shared: compute once, tile
    return (xB, xB, gbar, ops.comm0(3 * ops.M, torch.int32), ops.chan_init(xB))


def _svrp_round(ops: RoundOps, s, k):
    x, w, gbar, comm, ch = s
    m = ops.uniform_client(k)

    ch, x_d = ops.chan_down(ch, x)
    g_k = gbar - ops.grad(m, w)
    z = x_d - ops.vec(ops.hp.eta) * g_k
    x_next = ops.chan_up(ops.prox(m, z))

    c = ops.bernoulli(k)
    w_next = ops.where_vec(c, ops.chan_bcast(x_next), w)
    gbar_next = ops.refresh_grad(k, c, w_next, gbar)
    comm = comm + 2 + 3 * ops.M * ops.as_count(c)
    return (x_next, w_next, gbar_next, comm, ch), (ops.dist_sq(x_next), comm)


def _svrp_minibatch_round(ops: RoundOps, s, k):
    x, w, gbar, comm, ch = s
    ms = ops.sample_cohort(k)

    ch, x_d = ops.chan_down(ch, x)
    g_k = ops.expand(gbar) - ops.cohort_grad(ms, w)
    z = ops.expand(x_d) - ops.cvec(ops.hp.eta) * g_k
    ys = ops.chan_up(ops.cohort_prox(ms, z))
    x_next = ys.mean(dim=-2)

    c = ops.bernoulli(k)
    w_next = ops.where_vec(c, ops.chan_bcast(x_next), w)
    gbar_next = ops.refresh_grad(k, c, w_next, gbar)
    comm = comm + 2 * ops.cohort_size + 3 * ops.M * ops.as_count(c)
    return (x_next, w_next, gbar_next, comm, ch), (ops.dist_sq(x_next), comm)


def _deep_svrp_round(ops: RoundOps, s, k):
    """DeepSVRP's full-participation round: every client is a cohort and all
    M step at once, with Algorithm 7 at the explicit stepsize hp.local_lr
    (``ops.local_prox_gd``).  The refresh coin is the round's only draw."""
    x, w, gbar, comm, ch = s
    clients = ops.all_clients()

    ch, x_d = ops.chan_down(ch, x)
    g_k = ops.expand(gbar) - ops.cohort_grad(clients, w)
    z = ops.expand(x_d) - ops.cvec(ops.hp.eta) * g_k
    del g_k
    y = ops.local_prox_gd(z, x_d)
    x_next = ops.client_mean(ops.chan_up(y))
    del z, y

    c = ops.bernoulli(k)
    w_next = ops.where_vec(c, ops.chan_bcast(x_next), w)
    gbar_next = ops.refresh_grad(k, c, w_next, gbar)
    # 2M a round (x down, y up, every client) and a coin-gated 2M for the
    # anchor-gradient all-reduce.
    comm = comm + 2 * ops.M + 2 * ops.M * ops.as_count(c)
    return (x_next, w_next, gbar_next, comm, ch), (ops.dist_sq(x_next), comm)


ROUND_DEFS: dict[str, RoundDef] = {
    "sppm": RoundDef("sppm", _sppm_init, _sppm_round),
    "svrp": RoundDef("svrp", _svrp_init, _svrp_round),
    "svrp_minibatch": RoundDef("svrp_minibatch", _svrp_init, _svrp_minibatch_round),
    "deep_svrp": RoundDef("deep_svrp", _svrp_init, _deep_svrp_round),
}


def deep_local_prox_gd(problem, hp, lanes: tuple, dtype, device, local_steps: int) -> Callable:
    """DeepSVRP's local solver, the one binding every substrate shares:
    ``local_prox_gd(z, x)`` takes ``local_steps`` Algorithm-7 steps

        y <- y - local_lr (grad f_m(y) + (y - z_m) / eta)

    for every lane and client at once, from ``y0 = x``: ``z`` is
    ``S + (M, d)``, ``x`` ``S + (d,)`` broadcast over the clients (the
    round's start) or ``S + (M, d)``.  Each step is one
    K1 launch (`kernels.prox_update.prox_update_batched`; its plain version
    on CPU tensors) over the ``prod(S) * M`` rows, with each row's lane's
    ``local_lr`` and ``1/eta`` (the reference's `ref.prox_update_batched`
    and its Pallas kernel compute the same formula)."""
    from repro_torch.kernels.prox_update import prox_update_batched

    M = problem.num_clients

    def rows(h):
        lane = torch.as_tensor(h, dtype=dtype, device=device).broadcast_to(lanes).reshape(-1)
        return lane.repeat_interleave(M)

    lr_rows = rows(hp.local_lr)
    ie_rows = 1.0 / rows(hp.eta)
    m_rows = torch.arange(M, device=device).repeat(lr_rows.shape[0] // M)

    def local_prox_gd(z, x):
        d = z.shape[-1]
        z_rows = z.reshape(-1, d)
        y = (x if x.dim() == z.dim() else x.unsqueeze(-2)).expand(z.shape).reshape(-1, d)
        y = y.contiguous()  # one lane's rows are an expanded view; K1 takes dense rows
        for _ in range(local_steps):
            g = None  # the previous step's gradient, freed before the next is taken
            g = problem.grad(m_rows, y)
            y = prox_update_batched(y, g, z_rows, lr_rows, ie_rows)
        return y.reshape(z.shape)

    return local_prox_gd


# ========================================== sequential and registry substrates
#
# One binding for both: the registry prox solver over the record's lanes —
# one trial (``S = ()``, the ``*_scan`` drivers) or a ``(B,)`` sweep (the
# engine's default, `registry_batched_scan`).  Each solver takes per-lane
# eta and smoothness; ``newton`` and ``newton-cg`` test their lanes on the
# host once per iteration (a device sync each Newton step on the card).


def make_registry_ops(
    algo: str, problem, x0, x_star, hp, draws: Draws, *,
    prox_solver: str = "exact", prox_steps: int = 50, prox_tol: float = 1e-10,
    batch_clients: int | None = None, local_steps: int | None = None, prox_factors=None,
    channel=None,
) -> RoundOps:
    """Bind one rounds-defined algorithm to its registry prox solver over the
    lanes of ``draws``; ``hp`` fields are per-lane (or shared) scalars.
    deep_svrp binds its local Algorithm-7 loop (`deep_local_prox_gd`,
    ``local_steps`` steps) instead of a prox solver.

    ``prox_factors`` passes pre-hoisted solver state (Catalyst's spectral
    factors, hoisted once for every stage); otherwise the solver's own
    ``prepare`` runs here, once, before the first round."""
    from repro_torch.core.prox import get_prox_solver

    if algo == "deep_svrp":
        local = deep_local_prox_gd(problem, hp, draws.lanes, x0.dtype, x0.device, local_steps)
        return RoundOps(problem, hp, x_star, x0.dtype, draws=draws, local_prox_gd=local,
                        channel=channel)
    solver = get_prox_solver(prox_solver, problem)
    factors = prox_factors if prox_factors is not None else solver.prepare(problem)
    dtype, dev = x0.dtype, x0.device
    lanes = draws.lanes
    eta = torch.as_tensor(hp.eta, dtype=dtype, device=dev).broadcast_to(lanes)
    L = torch.as_tensor(getattr(hp, "smoothness", 0.0), dtype=dtype,
                        device=dev).broadcast_to(lanes)

    def solve(m, z, e, s):
        return solver.solve(problem, factors, m, z, e,
                            smoothness=s, steps=prox_steps, tol=prox_tol)

    kw: dict[str, Any] = {"channel": channel}
    if algo == "svrp_minibatch":
        cohort = lanes + (batch_clients,)
        eta_c, L_c = eta.unsqueeze(-1).expand(cohort), L.unsqueeze(-1).expand(cohort)
        kw["cohort_prox"] = lambda ms, z: solve(ms, z, eta_c, L_c)
        kw["cohort_size"] = batch_clients
    else:
        kw["prox"] = lambda m, z: solve(m, z, eta, L)
    return RoundOps(problem, hp, x_star, dtype, draws=draws, **kw)


def registry_step_def(algo: str, problem, x0, x_star, hp, draws, **binding) -> StepDef:
    """The rounds-defined algorithms' incremental unit: the same ``(init,
    round)`` pair `scan_rounds` runs, on `make_registry_ops`'s binding over
    the lanes of ``draws`` (a record, or the streaming server's
    `ResidentDraws`).  ``binding`` is forwarded (prox_solver, prox_steps,
    prox_tol, batch_clients, local_steps, channel)."""
    return round_step_def(ROUND_DEFS[algo],
                          make_registry_ops(algo, problem, x0, x_star, hp, draws, **binding), x0)


def registry_batched_scan(
    algo: str, problem, x0, x_star, draws: Draws, hp, *,
    num_steps: int, prox_solver: str = "exact", prox_steps: int = 50,
    prox_tol: float = 1e-10, batch_clients: int | None = None,
    local_steps: int | None = None, channel=None,
) -> RunResult:
    """Run one rounds-defined algorithm over the ``(B,)`` lanes of ``draws``
    with its registry prox solver (per-trial eta/smoothness per lane)."""
    sd = registry_step_def(
        algo, problem, x0, x_star, hp, draws, prox_solver=prox_solver,
        prox_steps=prox_steps, prox_tol=prox_tol, batch_clients=batch_clients,
        local_steps=local_steps, channel=channel,
    )
    return scan_step_def(sd, num_steps)


# Algorithms and problems whose tenants a session pool stacks into one lane
# batch: the single-client and cohort rounds on the plain quadratic.
POOL_STACKED_ALGOS = ("sppm", "svrp", "svrp_minibatch")


def pool_stacks(algo: str, problem) -> bool:
    """Whether `registry_pool_step_def` can stack tenants of ``algo`` on
    ``problem``'s family."""
    from repro_torch.problems.quadratic import QuadraticProblem

    return algo in POOL_STACKED_ALGOS and type(problem) is QuadraticProblem


def registry_pool_step_def(algo: str, problems, x_stars, hps, records, *, x0, **binding) -> StepDef:
    """The pool binding, the counterpart of the reference's
    ``registry_pool_scan``: the registry round of P tenants' sweeps as ONE
    ``(P B,)``-lane batch.  Tenant i's problem, x_star ``(d,)``, hparams
    (fields ``(B,)``) and record window ``records[i]`` (``(n, B)`` rows) are
    stacked in order: the problems' clients into one
    `problems.quadratic.PooledQuadraticProblem` (tenant i's clients offset
    by ``i M``, each tenant's lanes taking its own mean Hessian for the
    full gradient), the windows by `concat_trials` (host refresh masks
    OR-ed).  Only `pool_stacks` pairs qualify.  The step def's ``init`` is
    not used: the pool carries the tenants' states, concatenated on the
    lane axis; round k reads row k of the stacked windows."""
    from repro_torch.problems.quadratic import stack_quadratics

    B = records[0].num_trials
    pooled = stack_quadratics(problems)
    M = problems[0].num_clients
    draws = concat_trials(records, [i * M for i in range(len(problems))])
    hp = type(hps[0])(*(torch.cat([torch.as_tensor(h).broadcast_to((B,)) for h in field])
                        for field in zip(*hps)))
    x_star = torch.cat([xs.expand(B, -1) for xs in x_stars])
    return registry_step_def(algo, pooled, x0, x_star, hp, draws, **binding)


# ============================================================ fused substrate
#
# Two per-problem oracles, each running the whole Algorithm-7 loop in ONE
# launch: quadratic-family problems through the quadratic loop kernel (the
# reference's elementwise kernel and batched matvec per GD step, fused),
# logistic problems through the logistic kernel.


def fused_oracle_kind(problem) -> str:
    """Which fused Algorithm-7 oracle this problem supports ("quadratic" /
    "logistic"), raising a clear error otherwise."""
    if hasattr(problem, "A") and hasattr(problem, "b"):
        return "quadratic"
    if hasattr(problem, "Z") and hasattr(problem, "lam"):
        return "logistic"
    raise ValueError(
        f"fused=True has no batched kernel prox path for {type(problem).__name__}: "
        "supported oracles are the quadratic family (A/b attrs; "
        "kernels.quadratic_prox_gd_batched) and the logistic family (Z/y/lam "
        "attrs; kernels.logistic_prox_gd_indexed)"
    )


def prox_gd_fused(problem, m, z, eta, L, prox_steps: int):
    """The batched Algorithm-7 solve of one fused round: per-row sampled
    client ``m`` (R,), targets ``z`` (R, d), per-row eta/L scalars.  Rows are
    trials for single-client rounds and trial x cohort pairs for minibatch.
    ``m`` comes from the sweep's draws, whose range `run_batch` checked when
    the sweep started, so neither solve repeats the check; both read the
    sampled clients' data in place.

    DP-ERM noise fold: a problem with ``dp_linear_term(m)`` (the per-client
    objective-perturbation shift s_m) solves prox_{eta f^DP}(z) =
    prox_{eta f}(z - eta s_m) through the same kernel, from the unshifted
    start ``y0 = z``, as the reference does.  The quadratic branch needs no
    fold: the noise rides in ``problem.b``."""
    if fused_oracle_kind(problem) == "logistic":
        from repro_torch.kernels.logistic_prox import logistic_prox_gd_indexed

        beta = 1.0 / (L + 1.0 / eta)
        y0, target = None, z
        if hasattr(problem, "dp_linear_term"):
            target = z - eta[:, None] * problem.dp_linear_term(m)
            y0 = z
        return logistic_prox_gd_indexed(problem.Z, problem.y, m, target, beta, 1.0 / eta,
                                        problem.lam, prox_steps, y0=y0, check_indices=False)
    from repro_torch.core.prox import gd_row_scalars
    from repro_torch.kernels.prox_update import quadratic_prox_gd_batched

    beta, inv_eta = gd_row_scalars(z, eta, L)  # as prox_gd_batched takes them
    return quadratic_prox_gd_batched(problem.A, problem.b, m, z, beta, inv_eta, prox_steps,
                                     check_indices=False)


def _rows(a):
    """(B, b, d) cohort block -> (B*b, d) kernel rows."""
    B, b, d = a.shape
    return a.reshape(B * b, d)


def _per_trial(h, B: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(h, dtype=dtype, device=device).broadcast_to((B,)).contiguous()


def _fused_ops(algo: str, problem, hp, x_star, x0, draws: Draws, *,
               inner_steps: int, cohort_size: int | None = None,
               channel=None) -> RoundOps:
    """Bind one algorithm's fused substrate: injected draws + kernel prox."""
    dtype, dev = x0.dtype, x0.device
    B = draws.num_trials
    if algo == "deep_svrp":  # needs only problem.grad: no fused oracle kind
        local = deep_local_prox_gd(problem, hp, (B,), dtype, dev, inner_steps)
        return RoundOps(problem, hp, x_star, dtype, draws=draws, local_prox_gd=local,
                        channel=channel)
    eta = _per_trial(hp.eta, B, dtype, dev)
    L = _per_trial(getattr(hp, "smoothness", 0.0), B, dtype, dev)
    kw: dict[str, Any] = {"cohort_size": cohort_size, "channel": channel}

    if algo in ("sppm", "svrp"):
        kw["prox"] = lambda m, z: prox_gd_fused(problem, m, z, eta, L, inner_steps)
    elif algo == "svrp_minibatch":
        eta_rows = eta.repeat_interleave(cohort_size)
        L_rows = L.repeat_interleave(cohort_size)

        def cohort_prox(ms, z):
            y = prox_gd_fused(problem, ms.reshape(-1), _rows(z), eta_rows, L_rows, inner_steps)
            return y.reshape(z.shape)

        kw["cohort_prox"] = cohort_prox
    else:
        raise ValueError(f"no fused substrate for algo {algo!r}")

    return RoundOps(problem, hp, x_star, dtype, draws=draws, **kw)


def batched_scan(
    algo: str, problem, x0, x_star, draws: Draws, hp, *,
    num_steps: int, inner_steps: int, **static,
) -> RunResult:
    """The fused substrate's sweep driver: one hand-batched loop over (B, d)
    state for the whole trial batch.  ``inner_steps`` is the algorithm's
    Algorithm-7 step count."""
    if algo == "catalyzed_svrp":
        return _catalyzed_batched_scan(
            problem, x0, x_star, draws, hp,
            num_outer=static["num_outer"], num_steps=num_steps,
            inner_steps=inner_steps, channel=static.get("channel"),
        )
    ops = _fused_ops(
        algo, problem, hp, x_star, x0, draws, inner_steps=inner_steps,
        cohort_size=static.get("batch_clients"), channel=static.get("channel"),
    )
    return scan_rounds(ROUND_DEFS[algo], ops, x0, num_steps)


def _catalyzed_batched_scan(
    problem, x0, x_star, draws: Draws, hp, *,
    num_outer: int, num_steps: int, inner_steps: int, channel=None,
) -> RunResult:
    """Catalyzed SVRP on the fused substrate: the outer Catalyst recurrence
    hand-batched over (B,) with the inner loop running the SHARED SVRP round
    definition on per-trial shifted oracles

        h_t,m(x) = f_m(x) + gamma_b/2 ||x - y_b||^2,

    with the prox-GD update through the elementwise kernel
    (`prox_gd_batched`) on the shifted ``problem.grad``, for quadratic and
    logistic problems alike — the reference's form, so trajectories agree."""
    from repro_torch.core.prox import prox_gd_batched

    fused_oracle_kind(problem)
    B = draws.num_trials
    dtype, dev = x0.dtype, x0.device
    gamma, eta, L = (_per_trial(h, B, dtype, dev) for h in (hp.gamma, hp.eta, hp.smoothness))

    def stage_ops(y_prev, stage_draws):
        def grad_sh(m, y):
            return problem.grad(m, y) + gamma[:, None] * (y - y_prev)

        def full_grad_sh(w):
            return problem.full_grad(w) + gamma[:, None] * (w - y_prev)

        def prox(m, z):
            return prox_gd_batched(
                lambda y: grad_sh(m, y), z, eta, L, inner_steps, use_kernel=True
            )

        return RoundOps(
            problem, hp, x_star, dtype, draws=stage_draws,
            prox=prox, grad=grad_sh, full_grad=full_grad_sh, channel=channel,
        )

    sd = catalyst_step_def(stage_ops, x0, hp, draws, num_outer=num_outer, inner_steps=num_steps)
    return scan_step_def(sd, num_outer * num_steps)


class CatalystState(NamedTuple):
    """Catalyst's outer recurrence (x_{t-1}, y_{t-1}, alpha_{t-1}, the
    carried comm offset) and the current stage's binding, inner svrp state
    and position (None before a stage starts)."""

    x_prev: Any
    y_prev: Any
    alpha_prev: Any
    comm0: Any
    ops: Any = None
    inner: Any = None


def catalyst_step_def(stage_ops: Callable, x0, hp, draws: Draws, *,
                      num_outer: int, inner_steps: int) -> StepDef:
    """Catalyst's outer recurrence over lanes (Algorithm 3) as a `StepDef`
    of ``num_outer * inner_steps`` rounds, on any substrate.

    Round ``k`` is round ``pos = k % inner_steps`` of stage ``t = k //
    inner_steps``, which runs the shared svrp round on
    ``stage_ops(y_prev, draws.stage(t))`` — a binding whose oracles are the
    stage's shifted subproblem.  At a stage's first round the binding is
    made and the inner state starts from x_{t-1} (re-paying the 3M anchor
    setup, its channel state afresh, as the reference's inner svrp_scan
    re-runs _svrp_init); comm is the inner count on the carried int32
    offset; after its last round the stage extrapolates
    y_t = x_t + beta_t (x_t - x_{t-1})."""
    from repro_torch.core.catalyst import catalyst_extrapolate

    lanes = draws.lanes
    dtype, dev = x0.dtype, x0.device
    mu, gamma = (torch.as_tensor(h, dtype=dtype, device=dev).broadcast_to(lanes)
                 for h in (hp.mu, hp.gamma))
    q = mu / (mu + gamma)

    def init():
        xB = x0.expand(lanes + x0.shape).contiguous()
        return CatalystState(xB, xB, torch.sqrt(q), torch.zeros(lanes, dtype=torch.int32,
                                                                device=dev))

    def step(s: CatalystState, k: int):
        t, pos = divmod(k, inner_steps)
        ops, inner = s.ops, s.inner
        if pos == 0:
            ops = stage_ops(s.y_prev, draws.stage(t))
            inner = (s.x_prev, s.x_prev, ops.full_grad(s.x_prev),
                     ops.comm0(3 * ops.M, torch.int32), ops.chan_init(s.x_prev))
        inner, (d2, comm_in) = _svrp_round(ops, inner, pos)
        comm = comm_in + s.comm0
        if pos + 1 < inner_steps:
            return s._replace(ops=ops, inner=inner), (d2, comm)
        x_t = inner[0]
        alpha_t, beta_t = catalyst_extrapolate(s.alpha_prev, q)
        y_t = x_t + beta_t.unsqueeze(-1) * (x_t - s.x_prev)
        return CatalystState(x_t, y_t, alpha_t, comm), (d2, comm)

    def final(s: CatalystState):
        return s.x_prev if s.inner is None else s.inner[0]

    return StepDef(init, step, final)


# =============================================== client-sharded substrate
#
# The fourth substrate: the CLIENT axis (not the trial axis) over the ranks
# of a process group (`launch.mesh.make_client_mesh`).  Each rank holds a
# contiguous block of client state (data rows, DP noise shifts, per-client
# spectral factors; `problems.client_shard.shard_clients`) and runs the
# round definitions unchanged against `ClientShardedOps`.  The draws,
# hyperparameters and iterates are replicated, so every rank samples the
# same clients and the host refresh mask (`Draws.refresh`) decides every
# refresh on every rank alike: no rank reads its own block to decide
# whether to issue a collective.  The collective model, every collective an
# `all_reduce` (the reference's ``psum``):
#
# * per-client oracles (``grad`` / ``cohort_grad``) are computed by the
#   OWNER rank only and zeroed elsewhere: NO collective.  The wrong prox
#   inputs this leaves on the other ranks are discarded by the mask below;
# * the prox result is assembled by ONE `all_reduce` a round: the owner's
#   value plus zeros, exact, so the round's iterates are those of the
#   unsharded substrates bit for bit.  The local solves take LOCAL, clamped
#   client rows (`ClientShards.local_index`): the fused kernels read client
#   data unchecked;
# * the anchor refresh is one more `all_reduce` a refresh EVENT (a round
#   where some trial's coin is set): each rank's sum over its true clients,
#   summed and divided by the global M, and so is the round-0 anchor.  Only
#   there does the summation order differ from the unsharded substrates.
#
# Non-divisible M pads the client axis with zero rows at its end: the
# draws use the TRUE M (pads are never sampled) and ``valid`` keeps the pads
# out of every client mean, so padding never reaches a result.

# Planted fault for chip_smoke.py's checks: every rank adds its clamped
# local row to the round's sum, not only the owner (False in every real run).
_UNMASKED_PSUM = False


class ClientShardedOps(RoundOps):
    """`RoundOps` over a rank's resident client block.

    ``local_problem`` is this rank's contiguous block of ``M_local`` clients
    (global clients ``[rank M_local, ...)``); ``num_clients`` is the GLOBAL
    M, so sampling and the Section-4.2 accounting are those of every other
    substrate (comm integer-exact); ``valid`` is the replicated ``(M_pad,)``
    mask of the true clients."""

    def __init__(self, local_problem, hp, x_star, dtype, *, draws: Draws, mesh,
                 num_clients: int, valid, cohort_size: int | None = None, channel=None):
        from repro_torch.problems.client_shard import ClientShards

        super().__init__(local_problem, hp, x_star, dtype, draws=draws,
                         cohort_size=cohort_size, channel=channel)
        self.shards = ClientShards(local_problem, valid, mesh)
        self.M_local = local_problem.num_clients
        self.M = num_clients  # GLOBAL M: sampling + comm accounting

    def local_index(self, m):
        """Global client ids -> (the clamped local row, this rank owns it)."""
        return self.shards.local_index(m)

    def masked_psum(self, value, resident):
        """Assemble owner-computed rows: zeros elsewhere make the
        `all_reduce` exact.  ``resident`` broadcasts against ``value``'s
        leading axes."""
        if _UNMASKED_PSUM:
            resident = torch.ones_like(resident)
        return self.shards.assemble(value, resident)

    def all_clients(self):
        """Full participation over this rank's block: the global ids of its
        rows (every one resident), ``S + (M_local,)``."""
        ids = self.shards.offset + torch.arange(self.M_local, device=self.device)
        return ids.expand(self.lanes + (self.M_local,))

    def client_mean(self, y):
        """DeepSVRP's client mean of the block's rows: the sum over its true
        clients, the round's one `all_reduce`, divided by the global M.  The
        uplink channel compresses each row before this, as on every
        substrate."""
        return self.shards.row_mean(y)

    # ------------------------------------------------------------- oracles
    def grad(self, m, y):
        """Owner-masked sampled-client gradient, deliberately NOT summed:
        it only feeds the same client's prox input, whose result the
        round's single `masked_psum` assembles."""
        local, resident = self.local_index(m)
        g = self._grad(local, y)
        return torch.where(resident.unsqueeze(-1), g, torch.zeros_like(g))

    def cohort_grad(self, ms, y):
        local, resident = self.local_index(ms)
        g = self._grad(local, y[..., None, :].expand(ms.shape + y.shape[-1:]))
        return torch.where(resident.unsqueeze(-1), g, torch.zeros_like(g))

    def full_grad(self, w):
        """The anchor gradient at per-trial ``w``: one `all_reduce`."""
        return self.shards.full_grad(w)

    def init_full_grad(self, x0):
        """The round-0 anchor at the trial-shared ``x0``: one `all_reduce`."""
        return self.tile(self.shards.full_grad(x0))


def make_client_sharded_ops(
    algo: str, local_problem, x0, x_star, hp, draws: Draws, *,
    mesh, num_clients: int, valid, fused: bool = False, inner_steps: int | None = None,
    prox_solver: str = "exact", prox_steps: int = 50, prox_tol: float = 1e-10,
    batch_clients: int | None = None, local_steps: int | None = None, channel=None,
) -> ClientShardedOps:
    """Bind one rounds-defined algorithm to the client-sharded substrate.

    Mirrors `make_registry_ops` (registry solvers prepared on the LOCAL
    block: the spectral solver factorizes only the resident clients) and
    `_fused_ops` (``fused=True``: `prox_gd_fused`, K1's loop form for the
    quadratic and K2's indexed entry for the logistic problem and the DP
    fold, on the resident block), each local solve wrapped in the owner
    mask and the round's single `all_reduce`.  DeepSVRP's local loop is
    `deep_local_prox_gd` over the resident rows (elementwise K1 a step),
    whose raw rows the round's `client_mean` assembles after the uplink
    channel."""
    from repro_torch.core.prox import get_prox_solver

    dtype, dev = x0.dtype, x0.device
    ops = ClientShardedOps(local_problem, hp, x_star, dtype, draws=draws, mesh=mesh,
                           num_clients=num_clients, valid=valid, cohort_size=batch_clients,
                           channel=channel)
    if algo == "deep_svrp":
        steps = inner_steps if fused else local_steps
        ops.local_prox_gd = deep_local_prox_gd(local_problem, hp, draws.lanes, dtype, dev, steps)
        return ops
    lanes = draws.lanes
    eta = torch.as_tensor(hp.eta, dtype=dtype, device=dev).broadcast_to(lanes).contiguous()
    L = torch.as_tensor(getattr(hp, "smoothness", 0.0), dtype=dtype,
                        device=dev).broadcast_to(lanes).contiguous()
    b = batch_clients
    if fused:
        eta_c, L_c = eta.repeat_interleave(b or 1), L.repeat_interleave(b or 1)

        def solve(m, z, e, s):  # kernel rows: (R,) clients, (R, d) targets
            return prox_gd_fused(local_problem, m.reshape(-1), z.reshape(-1, z.shape[-1]), e, s,
                                 inner_steps).reshape(z.shape)
    else:
        solver = get_prox_solver(prox_solver, local_problem)
        factors = solver.prepare(local_problem)
        eta_c = eta.unsqueeze(-1).expand(lanes + (b,)) if b else eta
        L_c = L.unsqueeze(-1).expand(lanes + (b,)) if b else L

        def solve(m, z, e, s):
            return solver.solve(local_problem, factors, m, z, e,
                                smoothness=s, steps=prox_steps, tol=prox_tol)

    def prox(m, z):
        local, resident = ops.local_index(m)
        return ops.masked_psum(solve(local, z, eta_c, L_c), resident)

    if algo == "svrp_minibatch":
        ops.cohort_prox = prox
    else:
        ops.prox = prox
    return ops


def client_sharded_step_def(algo: str, local_problem, x0, x_star, hp, draws, **binding) -> StepDef:
    """The client-sharded substrate's incremental unit (the session layer's
    ``substrate="clients"``); ``binding`` forwards to
    `make_client_sharded_ops` (mesh, num_clients, valid, the solver)."""
    ops = make_client_sharded_ops(algo, local_problem, x0, x_star, hp, draws, **binding)
    return round_step_def(ROUND_DEFS[algo], ops, x0)


def client_sharded_scan(algo: str, local_problem, x0, x_star, draws, hp, *,
                        num_steps: int, **binding) -> RunResult:
    """Run one rounds-defined algorithm on the client-sharded substrate: this
    rank's share of ``run_batch(shard="clients")``."""
    return scan_step_def(
        client_sharded_step_def(algo, local_problem, x0, x_star, hp, draws, **binding), num_steps)


# ------------------------------------------------- pod (pytree) local solver
def local_prox_gd_tree(grad_fn: Callable, z, y0, local_lr, inv_eta, num_steps: int, *,
                       update_fn: Callable | None = None, g0=None):
    """DeepSVRP's K local Algorithm-7 steps over a parameter tree:
    ``y <- update_fn(y, grad_fn(y), z, lr, 1/eta)``, ``num_steps`` times.

    ``update_fn`` defaults to `kernels.ops.prox_update_tree` (K3, one launch
    per dtype group), looked up at call time.  Returns ``(y_K, g_{K-1})``:
    the last local gradient feeds the train step's "reuse_local" refresh;
    ``g0`` seeds that carry and is what ``num_steps == 0`` returns (zeros
    like ``y0`` when not given).  Each step drops the previous gradient
    before computing the next, so one gradient tree is alive at a time."""
    if update_fn is None:
        update_fn = kops.prox_update_tree
    if num_steps == 0:
        return y0, g0 if g0 is not None else tree_zeros_like(y0)
    y = y0
    for _ in range(num_steps):
        g = None  # the previous step's gradient, freed before the next is taken
        g = grad_fn(y)
        y = update_fn(y, g, z, local_lr, inv_eta)
    return y, g
