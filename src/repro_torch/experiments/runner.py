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

``shard=`` runs the sweep SPMD over the ranks of a `torch.distributed`
process group (`launch.mesh`; ``group=``, by default the initialised
default group, else a world of one on the device's backend): every rank
calls `run_batch` with the same arguments and the same problem, and every
rank returns the whole result.  Every collective is one `all_reduce`
(`launch.mesh.all_reduce`, counted).

* ``shard="data"`` splits the TRIAL axis: B is padded to a multiple of the
  ranks with copies of the last trial (its seed, hyperparameters and draws),
  each rank runs its contiguous block through the unsharded path's body,
  with no collective inside the rounds, and one `all_reduce` after the last
  round assembles the result (each rank's block written into zeros), the
  pad cut off;
* ``shard="clients"`` splits the CLIENT axis (`problems.client_shard`):
  each rank holds a contiguous block of the problem padded with zero
  clients, the draws, hyperparameters and iterates are replicated, and the
  rounds-defined algorithms run `rounds.client_sharded_scan` (one
  `all_reduce` a round, one a refresh event and one for the round-0
  anchor) while the others run their drivers against the
  `ClientShardedProblem` view (one `all_reduce` an oracle call).  The
  problem must declare ``client_shardable``.
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


def _prepare(spec_: RunSpec, problem, device):
    """Shared by the entry points: the device and the resolved run."""
    dev = problem_device(problem, device)
    full_precision_matmul()
    return dev, spec_.resolve(problem)


def _sweep_body(rr, fused: bool) -> Callable:
    """The sweep driver ``(problem, x0, x_star, draws, hp) -> RunResult`` of
    the unsharded path, which under ``shard="data"`` runs each rank's block:
    the fused substrate, the registry binding of the rounds-defined
    algorithms, or the algorithm's ``scan_fn`` over the lanes."""
    algo, cfg = rr.algo, rr.cfg
    if fused:
        return _fused_body(algo, tuple(sorted(cfg.items())))
    if algo in ROUND_DEFS:
        return lambda p, x0, xs, d, hp: registry_batched_scan(algo, p, x0, xs, d, hp, **cfg)
    return lambda p, x0, xs, d, hp: rr.aspec.scan_fn(p, x0, xs, d, hp, **cfg)


# ------------------------------------------------------------- sharded sweeps
# Float and integer outputs travel through the assembly's all_reduce as
# int64 words holding their bits (floats viewed as the integer of their
# width): the sum of one owner's words and zeros is the owner's, exactly.
_WORD = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}


def _to_words(t: torch.Tensor) -> torch.Tensor:
    if t.is_floating_point():
        t = t.contiguous().view(_WORD[t.element_size()])
    return t.reshape(t.shape[0], -1).to(torch.int64)


def _from_words(w: torch.Tensor, like: torch.Tensor, B: int) -> torch.Tensor:
    shape = (B,) + like.shape[1:]
    if like.is_floating_point():
        return w.to(_WORD[like.element_size()]).view(like.dtype).reshape(shape)
    return w.to(like.dtype).reshape(shape)


def _run_data_sharded(body: Callable, rr, problem, draws: Draws | None, dev, group) -> RunResult:
    """``shard="data"``: this rank's contiguous block of the trials padded to
    a multiple of the ranks (copies of the last trial), run by ``body``;
    each rank writes its block into zeros of the padded result and ONE
    `all_reduce` after the last round assembles it (owner value plus zeros,
    exact); the pad is cut off."""
    from repro_torch.launch.mesh import make_sweep_mesh

    mesh = make_sweep_mesh(group, dev)
    B = rr.seeds.shape[0]
    B_local = -(-B // mesh.size)
    lo = mesh.rank * B_local
    idx = torch.arange(lo, lo + B_local).clamp(max=B - 1)
    hp = rr._replace(hparams={k: v[idx.numpy()] for k, v in rr.hparams.items()}).device_hparams(dev)
    block = None if draws is None else draws.trials(idx).to(dev)
    res = body(problem, rr.x0, rr.x_star, block, hp)
    parts = (res.dist_sq, res.comm, res.x_final)
    words = [_to_words(t) for t in parts]
    full = torch.zeros((B_local * mesh.size, sum(w.shape[1] for w in words)), dtype=torch.int64,
                       device=dev)
    full[lo:lo + B_local] = torch.cat(words, dim=1)
    full = mesh.all_reduce(full)[:B]
    out, start = [], 0
    for t, w in zip(parts, words):
        out.append(_from_words(full[:, start:start + w.shape[1]], t, B))
        start += w.shape[1]
    return RunResult(*out)


def _run_client_sharded(rr, problem, draws: Draws | None, dev, group, fused: bool) -> RunResult:
    """``shard="clients"``: this rank's block of the problem padded with zero
    clients; the rounds-defined algorithms on `rounds.client_sharded_scan`
    (their registry solvers or, fused, their kernels on the resident
    block), the others' drivers against the `ClientShardedProblem` view.
    The draws carry global client ids; the outputs are replicated."""
    from repro_torch.core.rounds import client_sharded_scan
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.problems.client_shard import ClientShardedProblem, shard_clients

    mesh = make_client_mesh(group, dev)
    local, valid = shard_clients(problem, mesh)
    M = problem.num_clients
    algo, spec, cfg = rr.algo, rr.aspec, rr.cfg
    hp = rr.device_hparams(dev)
    draws = None if draws is None else draws.to(dev)
    if algo not in ROUND_DEFS:
        return spec.scan_fn(ClientShardedProblem(local, valid, mesh, M), rr.x0, rr.x_star, draws,
                            hp, **cfg)
    if fused:
        cfg = dict(fused=True, inner_steps=cfg[spec.fused_inner_steps],
                   num_steps=cfg[spec.fused_round_steps],
                   **{k: cfg[k] for k in ("batch_clients", "channel") if k in cfg})
    return client_sharded_scan(algo, local, rr.x0, rr.x_star, draws, hp, mesh=mesh,
                               num_clients=M, valid=valid, **cfg)


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
    group=None,
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
    first-hit round.  `shard="data"` / `"clients"` runs the sweep over the
    ranks of `group` (see the module docstring): every rank calls with the
    same arguments and returns the whole result.
    """
    spec_ = as_runspec(algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star,
                       stepsize=stepsize, target_eps=target_eps,
                       theory_constants=theory_constants, static=static)
    if stop_eps is not None:
        if fused or shard is not None or group is not None:
            raise ValueError(
                "stop_eps runs on the incremental session substrate; it cannot "
                "be combined with fused=, shard= or group="
            )
        from repro_torch.serve import open_session  # serve imports this module

        sess = open_session(dataclasses.replace(spec_, substrate="batched"), problem,
                            draws=draws, device=device)
        return sess.run_until(stop_eps)
    dev, rr = _prepare(spec_, problem, device)
    algo, spec, cfg = rr.algo, rr.aspec, rr.cfg
    if shard not in (None, "data", "clients"):
        raise ValueError(f"unknown shard mode {shard!r}; supported: 'data', 'clients'")
    if group is not None and shard is None:
        raise ValueError(
            "group= only applies with shard='data'/'clients' (did you forget it?)"
        )
    if shard == "clients":
        from repro_torch.problems.client_shard import check_client_shardable

        check_client_shardable(problem)
        if fused and algo not in ROUND_DEFS:
            raise ValueError(
                "fused=True with shard='clients' supports only the "
                f"rounds-defined algorithms {sorted(ROUND_DEFS)}; run "
                f"{algo!r} with fused=False"
            )
    if fused:
        if not (spec.fusable and cfg.get("prox_solver", "gd") == "gd"):
            raise ValueError(
                f"{algo}: fused=True requires a fusable algo with prox_solver='gd'"
            )
        if algo != "deep_svrp":  # deep_svrp's local loop needs only problem.grad
            fused_oracle_kind(problem)
    draws = _sweep_draws(spec, algo, cfg, rr.hparams, rr.seeds, problem.num_clients, draws)
    if shard == "clients":
        return _result(rr, _run_client_sharded(rr, problem, draws, dev, group, fused))
    body = _sweep_body(rr, fused)
    if shard == "data":
        return _result(rr, _run_data_sharded(body, rr, problem, draws, dev, group))
    draws = None if draws is None else draws.to(dev)
    return _result(rr, body(problem, rr.x0, rr.x_star, draws, rr.device_hparams(dev)))


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
    dev, rr = _prepare(spec_, problem, device)
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
