"""Batched multi-trial experiment engine: the fused sweep on the GPU.

Port of `repro.experiments.runner`, fused substrate only.  Every figure of
the paper averages SPPM/SVRP/Catalyzed-SVRP over many seeds and sweeps
stepsizes/cohorts; `run_batch(..., fused=True, prox_solver="gd")` runs the
whole ``seeds x grid`` sweep as one hand-batched loop over ``(B, d)`` state,
its Algorithm-7 local solves through the batched Hopper kernels:

    from repro_torch.experiments import run_batch

    res = run_batch(
        "svrp", problem,
        grid={"eta": [1e-3, 3e-3], "p": 1 / M, "smoothness": L},
        seeds=8, fused=True, num_steps=400, prox_solver="gd", prox_steps=20,
    )
    res.dist_sq            # (16, 400) per-trial trajectories
    res.summary()          # median/IQR over the batch axis

The random draws come from a `core.draws.Draws` record: by default
`draw_schedule` draws them natively from the trial seeds; ``draws=`` injects
a record (the tests replay the reference's PRNG keys into one, which makes
``comm`` integer-equal to `repro`'s).  `run_batch` runs on CUDA unless
``device=`` names another device, and never falls back to the CPU.

Not ported yet (each raises `NotImplementedError`): ``fused=False`` (the
registry-batched substrate), ``shard=``, ``stop_eps=`` and `run_sequential`.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.channel import wire_vector_bytes
from repro_torch.core.draws import Draws, draw_schedule
from repro_torch.core.rounds import batched_scan, fused_oracle_kind
from repro_torch.core.types import RunResult
from repro_torch.device import full_precision_matmul, resolve_device
from repro_torch.experiments.grid import trial_labels
from repro_torch.experiments.spec import ALGOS, RunSpec, as_runspec


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; this slice runs "
        "run_batch(..., fused=True, prox_solver='gd') — use repro for the rest"
    )


class BatchResult(NamedTuple):
    """Stacked `RunResult`s for a sweep batch, plus per-trial labels."""

    dist_sq: torch.Tensor  # (B, K)
    comm: torch.Tensor  # (B, K)
    x_final: torch.Tensor  # (B, d)
    hparams: dict[str, np.ndarray]  # each (B,)
    seeds: np.ndarray  # (B,)
    comm_bytes: np.ndarray | None = None  # (B, K) int64 wire-bytes ledger

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


def _expected_draws(algo: str, cfg: Mapping[str, Any], B: int) -> tuple[tuple, tuple | None]:
    """The (clients, coins) shapes a sweep consumes."""
    if algo == "catalyzed_svrp":
        lead = (cfg["num_outer"], cfg["inner_steps"], B)
        return lead, lead
    lead = (cfg["num_steps"], B)
    if algo == "svrp_minibatch":
        return lead + (cfg["batch_clients"],), lead
    return lead, (None if algo == "sppm" else lead)


def _check_draws(draws: Draws, algo: str, cfg: Mapping[str, Any], B: int, M: int) -> None:
    """Shapes, and client indices in [0, M): checked once here, so the
    kernels that read a client's data by index need not check every round."""
    clients, coins = _expected_draws(algo, cfg, B)
    got_coins = None if draws.coins is None else tuple(draws.coins.shape)
    if tuple(draws.clients.shape) != clients or got_coins != coins:
        raise ValueError(
            f"{algo}: the injected draws have clients {tuple(draws.clients.shape)} and "
            f"coins {got_coins}; this sweep needs clients {clients} and coins {coins}"
        )
    if draws.clients.numel():
        lo, hi = (int(v) for v in torch.aminmax(draws.clients))
        if lo < 0 or hi >= M:
            raise ValueError(f"{algo}: the draws' clients span [{lo}, {hi}], outside [0, {M})")


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
    seed-major); the remaining kwargs are the algo's static config.  The
    port runs only ``fused=True`` with ``prox_solver="gd"``.  `device`
    (default CUDA) must be the device `problem` lives on; `draws` injects the
    sweep's client indices and refresh coins (default: `draw_schedule`).
    """
    dev = resolve_device(device)
    full_precision_matmul()
    if problem.device != dev:
        raise ValueError(
            f"problem lives on {problem.device} but run_batch runs on {dev}; "
            "build the problem with device=..."
        )
    spec_ = as_runspec(algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star,
                       stepsize=stepsize, target_eps=target_eps,
                       theory_constants=theory_constants, static=static)
    if stop_eps is not None:
        raise _not_ported("stop_eps= (the incremental session substrate)")
    if shard is not None:
        raise _not_ported(f"shard={shard!r}")
    if not fused:
        raise _not_ported("fused=False (the registry-batched substrate)")
    rr = spec_.resolve(problem)
    algo, spec = rr.algo, rr.aspec
    hparams, seed_arr, cfg, x0, x_star = rr.hparams, rr.seeds, rr.cfg, rr.x0, rr.x_star

    if not (spec.fusable and cfg.get("prox_solver", "gd") == "gd"):
        raise ValueError(
            f"{algo}: fused=True requires a fusable algo with prox_solver='gd'"
        )
    fused_oracle_kind(problem)
    B = seed_arr.shape[0]
    if draws is None:
        draws = draw_schedule(
            seed_arr, problem.num_clients, cfg[spec.fused_round_steps],
            hparams.get("p"), batch_clients=cfg.get("batch_clients"),
            num_outer=cfg.get("num_outer"),
        )
    _check_draws(draws, algo, cfg, B, problem.num_clients)
    hp = rr.device_hparams(dev)
    res = _fused_body(algo, tuple(sorted(cfg.items())))(
        problem, x0, x_star, draws.to(dev), hp
    )
    return BatchResult(
        dist_sq=res.dist_sq,
        comm=res.comm,
        x_final=res.x_final,
        hparams=hparams,
        seeds=seed_arr,
        comm_bytes=ledger_bytes(cfg, x0, res.comm),
    )


def run_sequential(algo, problem, *args, **kwargs) -> BatchResult:
    """The per-trial loop of the reference; not ported yet."""
    raise _not_ported("run_sequential (the sequential substrate)")
