"""Batched multi-trial experiment engine: every sweep of the paper on the GPU.

Port of `repro.experiments.runner`.  Every figure of the paper averages
SPPM/SVRP/Catalyzed-SVRP (and the baselines) over many seeds and sweeps
stepsizes/cohorts; `run_batch` runs the whole ``seeds x grid`` sweep as one
loop over ``(B, d)`` lanes:

    from repro_torch.experiments import run_batch

    res = run_batch(
        "svrp", problem,
        grid={"eta": [1e-3, 3e-3], "p": 1 / M},
        seeds=8, num_steps=400,
    )
    res.dist_sq            # (16, 400) per-trial trajectories
    res.summary()          # median/IQR over the batch axis

Substrates (`repro_torch.core.rounds`): by default (``fused=False``) the
rounds-defined algorithms (sppm, svrp, svrp_minibatch, deep_svrp) run
`rounds.registry_batched_scan`, their registry prox solver (deep_svrp: its
local Algorithm-7 loop) over the lanes, and catalyzed_svrp, composite and
the baselines run their ``scan_fn`` over the same ``(B,)`` lanes (the
counterpart of the reference's vmap of the per-trial scan).  ``fused=True``
with ``prox_solver="gd"`` runs the fused substrate, the Algorithm-7 solves
through the batched Hopper kernels; deep_svrp's fused path needs only
``problem.grad``, so it also runs on `problems.fed_lm.FedLMProblem` (the
reference's fused path takes only quadratic and logistic problems).
`run_sequential` runs the same trials one driver call per trial.

The random draws come from a `core.draws.Draws` record: by default
`draw_schedule` draws them natively from the trial seeds (trial s draws the
same numbers in `run_batch` and `run_sequential`); ``draws=`` injects a
record (the tests replay the reference's PRNG keys into one, which makes
``comm`` integer-equal to `repro`'s).  Deterministic algorithms (dane,
acc_extragradient) draw nothing.  Both entry points run on CUDA unless
``device=`` names another device, and never fall back to the CPU.

``stop_eps=`` runs the sweep on the incremental session substrate
(`repro_torch.serve.open_session(...).run_until`): the same step
definitions over the same record, stepped a chunk at a time until every
trial has reached ``dist_sq <= stop_eps`` (or the horizon runs out).

Not ported yet (raises `NotImplementedError` naming its ROADMAP item):
``shard=`` (item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.channel import wire_vector_bytes
from repro_torch.core.draws import Draws, draw_schedule
from repro_torch.core.rounds import (
    ROUND_DEFS,
    batched_scan,
    fused_oracle_kind,
    registry_batched_scan,
)
from repro_torch.core.types import RunResult
from repro_torch.device import full_precision_matmul, problem_device
from repro_torch.experiments.grid import trial_labels
from repro_torch.experiments.spec import ALGOS, AlgoSpec, RunSpec, as_runspec, horizon_rounds


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP §1 {item}); use repro for it"
    )


class BatchResult(NamedTuple):
    """Stacked `RunResult`s for a sweep batch, plus per-trial labels.

    `stopped_round` is set only by the early-stopping path
    (`run_batch(..., stop_eps=...)` / `FedSession.run_until`): per trial, the
    1-based round at which dist_sq first reached the threshold, or -1 if it
    never did within the rounds run.  K is then the number of rounds run;
    the trajectories are the full run's prefix."""

    dist_sq: torch.Tensor  # (B, K)
    comm: torch.Tensor  # (B, K)
    x_final: torch.Tensor  # (B, d)
    hparams: dict[str, np.ndarray]  # each (B,)
    seeds: np.ndarray  # (B,)
    comm_bytes: np.ndarray | None = None  # (B, K) int64 wire-bytes ledger
    stopped_round: np.ndarray | None = None  # (B,) early-stopping path only

    @property
    def num_trials(self) -> int:
        return self.dist_sq.shape[0]

    def trial(self, i: int) -> RunResult:
        cb = None if self.comm_bytes is None else self.comm_bytes[i]
        return RunResult(self.dist_sq[i], self.comm[i], self.x_final[i], cb)

    def labels(self) -> list[dict[str, float]]:
        return trial_labels(self.hparams, self.seeds)

    def _first_hit(self, counts: np.ndarray, eps: float) -> np.ndarray:
        hit = self.dist_sq.cpu().numpy() <= eps
        out = np.full(hit.shape[0], np.inf)
        for i in range(hit.shape[0]):
            if hit[i].any():
                out[i] = counts[i, int(np.argmax(hit[i]))]
        return out

    def comm_to_accuracy(self, eps: float) -> np.ndarray:
        """(B,) first cumulative-comm count at which dist_sq <= eps (inf if never)."""
        return self._first_hit(self.comm.cpu().numpy().astype(np.float64), eps)

    def bytes_to_accuracy(self, eps: float) -> np.ndarray:
        """(B,) first cumulative WIRE BYTES at which dist_sq <= eps (inf if never)."""
        if self.comm_bytes is None:
            raise ValueError(
                "comm_bytes is not populated; run through run_batch, which "
                "attaches the bytes ledger"
            )
        return self._first_hit(np.asarray(self.comm_bytes, dtype=np.float64), eps)

    def final_at_budget(self, budget: int) -> float:
        """Median over trials of dist_sq at the LAST step with comm <= budget;
        NaN if no trial has any step within budget."""
        comm = self.comm.cpu().numpy()
        d2 = self.dist_sq.cpu().numpy()
        finals = [
            d2[i, np.searchsorted(comm[i], budget, side="right") - 1]
            for i in range(comm.shape[0])
            if comm[i, 0] <= budget
        ]
        return float(np.median(finals)) if finals else float("nan")

    def summary(self, q: tuple[float, float] = (25.0, 75.0)) -> dict[str, np.ndarray]:
        """Median/IQR trajectories over the batch axis (the paper's shaded bands)."""
        d2 = self.dist_sq.cpu().numpy()
        lo, hi = q
        out = {
            "dist_sq_median": np.median(d2, axis=0),
            "dist_sq_q_lo": np.percentile(d2, lo, axis=0),
            "dist_sq_q_hi": np.percentile(d2, hi, axis=0),
            "comm_median": np.median(self.comm.cpu().numpy(), axis=0),
        }
        if self.comm_bytes is not None:
            out["comm_bytes_median"] = np.median(self.comm_bytes, axis=0)
        return out


def ledger_bytes(cfg: Mapping[str, Any], x0: torch.Tensor, comm) -> np.ndarray:
    """The int64 bytes-on-the-wire ledger for a (B, K) cumulative comm
    trajectory, computed on the host: every counted exchange is one
    d-vector, so bytes = comm x the channel's wire size for that vector."""
    wire = wire_vector_bytes(cfg.get("channel"), x0.numel(), x0.element_size())
    return np.asarray(torch.as_tensor(comm).cpu().numpy(), dtype=np.int64) * np.int64(wire)


def _expected_draws(algo: str, cfg: Mapping[str, Any], B: int) -> tuple[tuple | None, tuple | None]:
    """The (clients, coins) shapes a sweep consumes (None: draws none)."""
    lead = (horizon_rounds(cfg), B)
    if algo == "catalyzed_svrp":
        lead = (cfg["num_outer"],) + lead
        return lead, lead
    if algo == "svrp_minibatch":
        return lead + (cfg["batch_clients"],), lead
    if algo == "deep_svrp":
        return None, lead
    return lead, (lead if algo in ("svrp", "svrg", "composite") else None)


def _check_draws(draws: Draws, algo: str, cfg: Mapping[str, Any], B: int, M: int) -> None:
    """Shapes, and client indices in [0, M): checked once here, so the
    kernels that read a client's data by index need not check every round."""
    clients, coins = _expected_draws(algo, cfg, B)
    got_coins = None if draws.coins is None else tuple(draws.coins.shape)
    got_clients = None if draws.clients is None else tuple(draws.clients.shape)
    if got_clients != clients or got_coins != coins:
        raise ValueError(
            f"{algo}: the injected draws have clients {got_clients} and "
            f"coins {got_coins}; this sweep needs clients {clients} and coins {coins}"
        )
    if got_clients is not None and draws.clients.numel():
        lo, hi = (int(v) for v in torch.aminmax(draws.clients))
        if lo < 0 or hi >= M:
            raise ValueError(f"{algo}: the draws' clients span [{lo}, {hi}], outside [0, {M})")


def _sweep_draws(spec: AlgoSpec, algo: str, cfg, hparams, seeds: np.ndarray, M: int,
                 draws: Draws | None) -> Draws | None:
    """The sweep's draws on the host: ``draws`` checked, or drawn natively
    from the trial seeds; None for a deterministic algorithm."""
    if spec.deterministic:
        if draws is not None:
            raise ValueError(f"{algo} is deterministic: it takes no draws")
        return None
    if draws is None:
        draws = draw_schedule(
            seeds, M, horizon_rounds(cfg), hparams.get("p", hparams.get("anchor_prob")),
            batch_clients=cfg.get("batch_clients"), num_outer=cfg.get("num_outer"),
            clients=algo != "deep_svrp",
        )
    _check_draws(draws, algo, cfg, seeds.shape[0], M)
    return draws


def _fused_body(algo: str, static_items: tuple) -> Callable:
    """The fused-substrate driver for one algorithm and static config: the
    AlgoSpec's `fused_inner_steps` / `fused_round_steps` name which entries
    feed the Algorithm-7 inner loop and the round loop."""
    spec = ALGOS[algo]
    cfg = dict(static_items)
    inner_steps = cfg[spec.fused_inner_steps]
    num_steps = cfg[spec.fused_round_steps]
    extra = {k: cfg[k] for k in ("batch_clients", "num_outer", "channel") if k in cfg}

    def run(problem, x0, x_star, draws, hp):
        return batched_scan(
            algo, problem, x0, x_star, draws, hp,
            num_steps=num_steps, inner_steps=inner_steps, **extra,
        )

    return run


def _prepare(spec_: RunSpec, problem, device, shard):
    """Shared by both entry points: the device, the unported options, the
    resolved run."""
    dev = problem_device(problem, device)
    full_precision_matmul()
    if shard is not None:
        raise _not_ported(f"shard={shard!r} (the client-sharded substrate)", "item 6")
    return dev, spec_.resolve(problem)


def _result(rr, res: RunResult) -> BatchResult:
    return BatchResult(
        dist_sq=res.dist_sq,
        comm=res.comm,
        x_final=res.x_final,
        hparams=rr.hparams,
        seeds=rr.seeds,
        comm_bytes=ledger_bytes(rr.cfg, rr.x0, res.comm),
    )


def run_batch(
    algo: str | RunSpec,
    problem,
    grid: Mapping[str, Any] | None = None,
    seeds: int | Sequence[int] = 1,
    *,
    x0: torch.Tensor | None = None,
    x_star: torch.Tensor | None = None,
    stepsize: str | None = None,
    target_eps: float = 1e-6,
    theory_constants=None,
    fused: bool = False,
    shard: str | None = None,
    stop_eps: float | None = None,
    draws: Draws | None = None,
    device: str | torch.device | None = None,
    **static,
) -> BatchResult:
    """Run `seeds x grid` trials of `algo` on `problem` as one batched sweep.

    Arguments follow the reference's `run_batch`: `grid` maps hparam names to
    scalars or sequences (crossed cartesian-style, then with the seed axis,
    seed-major); the remaining kwargs are the algo's static config.
    `stepsize="theory"` resolves the grid from the theorem table
    (`core.theory.theory_grid`).  `fused=True` (fusable algos with
    prox_solver="gd") runs the fused substrate.  `device` (default CUDA)
    must be the device `problem` lives on; `draws` injects the sweep's client
    indices and refresh coins (default: `draw_schedule`).  `stop_eps` stops
    early on the session substrate: the returned trajectories are the full
    run's prefix and `BatchResult.stopped_round` holds each trial's
    first-hit round.
    """
    spec_ = as_runspec(algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star,
                       stepsize=stepsize, target_eps=target_eps,
                       theory_constants=theory_constants, static=static)
    if stop_eps is not None:
        if fused or shard is not None:
            raise ValueError(
                "stop_eps runs on the incremental session substrate; it cannot "
                "be combined with fused= or shard="
            )
        from repro_torch.serve import open_session  # serve imports this module

        sess = open_session(dataclasses.replace(spec_, substrate="batched"), problem,
                            draws=draws, device=device)
        return sess.run_until(stop_eps)
    dev, rr = _prepare(spec_, problem, device, shard)
    algo, spec, cfg = rr.algo, rr.aspec, rr.cfg
    if fused:
        if not (spec.fusable and cfg.get("prox_solver", "gd") == "gd"):
            raise ValueError(
                f"{algo}: fused=True requires a fusable algo with prox_solver='gd'"
            )
        if algo != "deep_svrp":  # deep_svrp's local loop needs only problem.grad
            fused_oracle_kind(problem)
    draws = _sweep_draws(spec, algo, cfg, rr.hparams, rr.seeds, problem.num_clients, draws)
    draws = None if draws is None else draws.to(dev)
    hp = rr.device_hparams(dev)
    if fused:
        res = _fused_body(algo, tuple(sorted(cfg.items())))(problem, rr.x0, rr.x_star, draws, hp)
    elif algo in ROUND_DEFS:
        res = registry_batched_scan(algo, problem, rr.x0, rr.x_star, draws, hp, **cfg)
    else:
        res = spec.scan_fn(problem, rr.x0, rr.x_star, draws, hp, **cfg)
    return _result(rr, res)


def run_sequential(
    algo: str | RunSpec,
    problem,
    grid: Mapping[str, Any] | None = None,
    seeds: int | Sequence[int] = 1,
    *,
    x0: torch.Tensor | None = None,
    x_star: torch.Tensor | None = None,
    stepsize: str | None = None,
    target_eps: float = 1e-6,
    theory_constants=None,
    draws: Draws | None = None,
    device: str | torch.device | None = None,
    **static,
) -> BatchResult:
    """The per-trial loop `run_batch` replaces: the same trials, one driver
    call (`AlgoSpec.scan_fn` over one trial's lane) per trial, each reading
    its own trial of the sweep's draws (``draws=``, or drawn natively from
    the seeds as `run_batch` draws them)."""
    spec_ = as_runspec(algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star,
                       stepsize=stepsize, target_eps=target_eps,
                       theory_constants=theory_constants, static=static)
    dev, rr = _prepare(spec_, problem, device, None)
    spec = rr.aspec
    draws = _sweep_draws(spec, rr.algo, rr.cfg, rr.hparams, rr.seeds, problem.num_clients, draws)
    hp_all = rr.device_hparams(dev)
    results = []
    for i in range(rr.seeds.shape[0]):
        hp = spec.params_cls(*(h[i] for h in hp_all))
        trial = None if draws is None else draws.trial(i).to(dev)
        results.append(spec.scan_fn(problem, rr.x0, rr.x_star, trial, hp, **rr.cfg))
    return _result(rr, RunResult(
        dist_sq=torch.stack([r.dist_sq for r in results]),
        comm=torch.stack([r.comm for r in results]),
        x_final=torch.stack([r.x_final for r in results]),
    ))
