"""Incremental round engine: `open_session` / `FedSession`.

Port of `repro.serve.session`.  The batch engine
(`repro_torch.experiments.run_batch`) runs a whole sweep; this module exposes
the SAME step definitions — every algorithm's `core.types.StepDef`
(`core.rounds.registry_step_def` for the rounds-defined algorithms,
`core.catalyst.catalyzed_step_def`, the baselines' and composite's
``*_step_def``) — as an incremental API:

    from repro_torch.serve import open_session

    session = open_session("svrp", problem,
                           grid={"eta": 1e-2, "p": 0.1}, seeds=8,
                           num_steps=2000)
    session.step()            # one round, all trials
    session.step(n=50)        # fifty more
    res = session.run_until(eps=1e-8)   # early stopping -> BatchResult

k incremental rounds are the first k columns of `run_batch`'s trajectories
over the same record, bit for bit: `run_batch` runs the same step
definition from round 0 for the whole horizon (`core.types.scan_step_def`)
and a session runs it a chunk at a time (`core.types.step_rounds`).  The
reference needs its full key schedule at open because ``split`` is not
prefix-stable; the port's counterpart is the `core.draws.Draws` record,
drawn once for the whole horizon at open (as `run_batch` draws it, or
injected with ``draws=``) and never extended: a chunk of rounds ``[t, t +
n)`` reads rows ``[t, t + n)``, the host refresh mask included, so no chunk
waits on the device to decide a refresh.  Stepping past the horizon raises.

Substrates:

* ``substrate="batched"`` (default): one state over the ``(B,)`` lanes of
  every trial, stepped by the registry binding `run_batch(fused=False)`
  uses (DeepSVRP on the federated LM: K1 a local step, K4 / K4b a client
  gradient on the card) or the algorithm's step over the lanes;
* ``substrate="sequential"``: one state per trial, each stepped by the same
  step definition over its own lane (the `run_sequential` oracle, steppable);
* ``substrate="clients"``: the client-sharded substrate (the session
  counterpart of ``run_batch(shard="clients")``): over the ranks of the
  default process group (or a world of one), each rank's block of the
  padded problem stays resident on its device across chunks, the state
  over the ``(B,)`` lanes is replicated, and each round is
  `core.rounds.client_sharded_step_def` (the rounds-defined algorithms) or
  the algorithm's step against `problems.client_shard.ClientShardedProblem`.
  Every rank opens the session with the same arguments and steps it alike.

State stays on the device between `step` calls; the round layer replaces
its tensors each round, so nothing is donated or copied back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.baselines import (
    acc_extragradient_step_def,
    dane_step_def,
    scaffold_step_def,
    sgd_step_def,
    svrg_step_def,
)
from repro_torch.core.catalyst import catalyzed_step_def
from repro_torch.core.composite import composite_step_def
from repro_torch.core.draws import Draws
from repro_torch.core.rounds import ROUND_DEFS, client_sharded_step_def, registry_step_def
from repro_torch.core.types import StepDef, step_rounds
from repro_torch.experiments.runner import BatchResult, _prepare, _sweep_draws, ledger_bytes
from repro_torch.experiments.spec import RunSpec, as_runspec, check_substrate, session_horizon

# Static-config keys that parameterize the registry round binding (the prox
# trio, the cohort size, the local-loop length, the comm channel).
_REGISTRY_BINDING = (
    "prox_solver", "prox_steps", "prox_tol", "batch_clients", "local_steps", "channel",
)


def trial_step_def(algo: str, problem, x0, x_star, hp, cfg: Mapping[str, Any],
                   draws: Draws | None) -> StepDef:
    """The `StepDef` of ANY `ALGOS` entry over the lanes of ``hp`` (scalar
    fields: one trial; ``(B,)`` fields: a sweep), bound to ``draws`` (None
    for the deterministic algorithms)."""
    if algo in ROUND_DEFS:
        binding = {k: cfg[k] for k in _REGISTRY_BINDING if k in cfg}
        return registry_step_def(algo, problem, x0, x_star, hp, draws, **binding)
    if algo == "catalyzed_svrp":
        return catalyzed_step_def(
            problem, x0, x_star, hp, draws,
            num_outer=cfg["num_outer"], inner_steps=cfg["inner_steps"],
            prox_solver=cfg["prox_solver"], prox_steps=cfg["prox_steps"],
            prox_tol=cfg["prox_tol"], channel=cfg.get("channel"),
        )
    if algo == "sgd":
        return sgd_step_def(problem, x0, x_star, hp, draws)
    if algo == "svrg":
        return svrg_step_def(problem, x0, x_star, hp, draws)
    if algo == "scaffold":
        return scaffold_step_def(problem, x0, x_star, hp, draws, local_steps=cfg["local_steps"])
    if algo == "dane":
        return dane_step_def(problem, x0, x_star, hp, surrogate_client=cfg["surrogate_client"])
    if algo == "acc_extragradient":
        return acc_extragradient_step_def(problem, x0, x_star, hp,
                                          surrogate_client=cfg["surrogate_client"])
    if algo == "composite":
        return composite_step_def(problem, x0, x_star, draws, hp, prox_R=cfg["prox_R"],
                                  prox_steps=cfg["prox_steps"])
    raise KeyError(f"no incremental step definition for algo {algo!r}")


def client_step_def(algo: str, problem, x0, x_star, hp, cfg: Mapping[str, Any],
                    draws: Draws | None, device) -> StepDef:
    """The `StepDef` of ANY `ALGOS` entry on the client-sharded substrate
    over the default group's ranks: this rank's block of ``problem`` on
    ``device``, the rounds-defined algorithms through
    `client_sharded_step_def` (their registry solvers), the others'
    steps against the `ClientShardedProblem` view."""
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.problems.client_shard import (
        ClientShardedProblem,
        check_client_shardable,
        shard_clients,
    )

    check_client_shardable(problem)
    mesh = make_client_mesh(device=device)
    local, valid = shard_clients(problem, mesh)
    M = problem.num_clients
    if algo in ROUND_DEFS:
        binding = {k: cfg[k] for k in _REGISTRY_BINDING if k in cfg}
        return client_sharded_step_def(algo, local, x0, x_star, hp, draws, mesh=mesh,
                                       num_clients=M, valid=valid, **binding)
    return trial_step_def(algo, ClientShardedProblem(local, valid, mesh, M), x0, x_star, hp,
                          cfg, draws)


class FedSession:
    """A sweep held open: device-resident state, stepped n rounds at a time.

    Construct via `open_session`.  All trials advance together; `step(n)`
    returns the `(B, n)` dist-sq / comm block for the rounds just run, and the
    session accumulates the full trajectory so `result()` yields the same
    `BatchResult` a `run_batch` of the rounds-so-far would."""

    def __init__(self, spec: RunSpec, problem, *, draws: Draws | None = None,
                 device: str | torch.device | None = None) -> None:
        substrate = check_substrate(spec.substrate or "batched")
        dev, rr = _prepare(spec, problem, device)
        self._spec = spec
        self._problem = problem
        self._substrate = substrate
        self._algo = rr.algo
        self._cfg = rr.cfg
        self._hparams, self._seeds = rr.hparams, rr.seeds
        self._x0, self._x_star = rr.x0, rr.x_star
        self._device = dev
        self._horizon = session_horizon(rr.cfg)
        self._B = int(rr.seeds.shape[0])
        # The whole horizon's record, drawn (or checked) once, on the host.
        self._draws = _sweep_draws(rr.aspec, rr.algo, rr.cfg, rr.hparams, rr.seeds,
                                   problem.num_clients, draws)
        self._hp = rr.device_hparams(dev)
        self._t = 0
        self._d2: list[torch.Tensor] = []  # (B, n) chunks
        self._comm: list[torch.Tensor] = []
        record = None if self._draws is None else self._draws.to(dev)
        if substrate == "batched":
            self._sds = [trial_step_def(rr.algo, problem, rr.x0, rr.x_star, self._hp, rr.cfg,
                                        record)]
        elif substrate == "clients":
            self._sds = [client_step_def(rr.algo, problem, rr.x0, rr.x_star, self._hp, rr.cfg,
                                         record, dev)]
        else:
            self._sds = [
                trial_step_def(rr.algo, problem, rr.x0, rr.x_star, self._hp_i(i), rr.cfg,
                               None if self._draws is None else self._draws.trial(i).to(dev))
                for i in range(self._B)
            ]
        self._state = [sd.init() for sd in self._sds]

    # ------------------------------------------------------------ inspection
    @property
    def t(self) -> int:
        """Rounds executed so far."""
        return self._t

    @property
    def horizon(self) -> int:
        """Total rounds the record covers (fixed at open)."""
        return self._horizon

    @property
    def num_trials(self) -> int:
        return self._B

    @property
    def substrate(self) -> str:
        return self._substrate

    @property
    def draws(self) -> Draws | None:
        """The horizon's record (host tensors), None for a deterministic algorithm."""
        return self._draws

    @property
    def dist_sq(self) -> torch.Tensor:
        """(B, t) trajectory so far."""
        if not self._d2:
            return torch.zeros((self._B, 0), dtype=self._x0.dtype, device=self._device)
        return torch.cat(self._d2, dim=1)

    @property
    def comm(self) -> torch.Tensor:
        if not self._comm:
            return torch.zeros((self._B, 0), dtype=torch.int32, device=self._device)
        return torch.cat(self._comm, dim=1)

    @property
    def comm_bytes(self) -> np.ndarray:
        """(B, t) cumulative wire-bytes ledger (host int64; see
        `experiments.runner.ledger_bytes`)."""
        return ledger_bytes(self._cfg, self._x0, self.comm)

    @property
    def flops(self) -> np.ndarray:
        """(B, t) cumulative analytic-FLOPs ledger — the compute mirror of
        `comm_bytes`, exact per trial (refresh rounds reconstructed from the
        comm trajectory; `core.flops.ledger_flops`)."""
        from repro_torch.core.flops import ledger_flops

        return ledger_flops(self._algo, self._cfg, self._problem, self.comm.cpu().numpy())

    def x(self) -> torch.Tensor:
        """(B, d) current iterates."""
        finals = [sd.final(s) for sd, s in zip(self._sds, self._state)]
        return torch.stack(finals) if self._substrate == "sequential" else finals[0]

    def _hp_i(self, i: int):
        return type(self._hp)(*(h[i] for h in self._hp))

    # -------------------------------------------------------------- stepping
    def check_horizon(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"step(n={n}): n must be >= 1")
        if self._t + n > self._horizon:
            raise ValueError(
                f"session horizon exhausted: {self._t} rounds done, {n} more "
                f"requested, horizon {self._horizon}.  The draws record is "
                "fixed at open (drawn once for the horizon) — open a new "
                "session with a larger round budget to continue."
            )

    def step(self, n: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """Advance every trial `n` rounds (rows ``[t, t + n)`` of the record);
        returns the `(B, n)` dist-sq and cumulative-comm block."""
        self.check_horizon(n)
        outs = []
        for i, sd in enumerate(self._sds):
            self._state[i], out = step_rounds(sd, self._state[i], self._t, n)
            outs.append(out)
        if self._substrate == "sequential":
            d2, comm = (torch.stack(v) for v in zip(*outs))
        else:
            d2, comm = outs[0]
        self.record(d2, comm)
        return d2, comm

    def record(self, d2: torch.Tensor, comm: torch.Tensor) -> None:
        """Append a ``(B, n)`` block of rounds run for this session (by
        `step`, or by a `SessionPool` that carries its state)."""
        self._t += d2.shape[1]
        self._d2.append(d2)
        self._comm.append(comm)

    def run_until(
        self, eps: float, *, max_rounds: int | None = None, chunk: int = 32
    ) -> BatchResult:
        """Step in chunks until EVERY trial has reached `dist_sq <= eps` at
        least once (or the horizon / `max_rounds` budget runs out); returns
        the accumulated `BatchResult` with per-trial `stopped_round` counts.

        The trajectories are the exact prefix of the full-horizon run —
        early stopping changes how far the session goes, never what it
        computes.  Each chunk's dist_sq is read back to test it."""
        limit = self._horizon if max_rounds is None else min(self._horizon, self._t + max_rounds)
        while self._t < limit and not self.all_reached(eps):
            self.step(min(chunk, limit - self._t))
        return self.result(stopped_round=self.first_hit(eps))

    def first_hit(self, eps: float) -> np.ndarray:
        """(B,) 1-based round of first dist_sq <= eps, -1 if not yet reached."""
        d2 = self.dist_sq.cpu().numpy()
        if d2.shape[1] == 0:
            return np.full(self._B, -1, dtype=np.int64)
        hit = d2 <= eps
        return np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, -1)

    def all_reached(self, eps: float) -> bool:
        return bool((self.first_hit(eps) >= 0).all())

    # ---------------------------------------------------------------- result
    def result(self, stopped_round: np.ndarray | None = None) -> BatchResult:
        """The rounds-so-far as a `BatchResult` (same layout as run_batch)."""
        return BatchResult(
            dist_sq=self.dist_sq,
            comm=self.comm,
            x_final=self.x(),
            hparams=self._hparams,
            seeds=self._seeds,
            comm_bytes=self.comm_bytes,
            stopped_round=stopped_round,
        )


def open_session(
    algo: str | RunSpec,
    problem,
    substrate: str | None = None,
    grid: Mapping[str, Any] | None = None,
    seeds: int | Sequence[int] = 1,
    *,
    x0: torch.Tensor | None = None,
    x_star: torch.Tensor | None = None,
    stepsize: str | None = None,
    target_eps: float = 1e-6,
    theory_constants: Any = None,
    draws: Draws | None = None,
    device: str | torch.device | None = None,
    **static,
) -> FedSession:
    """Open an incremental session for the same sweep `run_batch` would run.

    Accepts a `RunSpec` (whose `substrate` field picks the execution mode) or
    the keyword style — the same `as_runspec` / `RunSpec.resolve` path as
    `run_batch` / `run_sequential`, so the trial table, defaults and every
    validation error match.  ``draws`` injects the horizon's record (else it
    is drawn from the seeds as `run_batch` draws it); ``device`` (default
    CUDA) must be where ``problem`` lives."""
    spec = as_runspec(
        algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star, stepsize=stepsize,
        target_eps=target_eps, theory_constants=theory_constants,
        substrate=substrate, static=static,
    )
    spec = dataclasses.replace(spec, substrate=check_substrate(spec.substrate or "batched"))
    return FedSession(spec, problem, draws=draws, device=device)
