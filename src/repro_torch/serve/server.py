"""Streaming federated simulation server: continuous rounds over a churning
client population.

Port of `repro.serve.server`.  The batch engine answers "what would M fixed
clients converge to"; a federated deployment looks different — clients
connect and drop on a stream, cohorts form from whoever is resident, and the
server keeps rounds flowing while the population shifts:

* `ClientStream` — host-side churn (numpy `default_rng`, the reference's
  code, so the same seed gives the same masks bit for bit): each tick, every
  client flips residency with probability `churn`, with a minimum-resident
  guard so a round never starves.
* `FedRoundServer` — continuous sppm / svrp / svrp_minibatch / deep_svrp
  rounds.  The round body is the one registry binding
  (`core.rounds.registry_step_def`); only its draw source changes: a
  `core.draws.ResidentDraws` draws each round's client (or cohort, without
  replacement) over the clients resident when the round starts, and its
  refresh coin, on the host from the server's own `torch.Generator` seeded
  with ``seed`` — or reads them from a replayed record (``draws=``; the tests
  replay the reference's masked categorical and Gumbel top-k, drawn from
  ``fold_in(key(seed), t)``, which PyTorch cannot draw).  A round touches
  only resident clients (DeepSVRP, full participation, every client).
* `pipeline_depth` rounds in flight: round t+1 is queued on the device
  before round t's scalars are read back (`serve.stats.PipelinedReadback`).
* `ServeStats` — rounds/sec, p50/p95/p99 round latency, the
  dist-to-opt-over-wall-clock trace, and the analytic FLOPs
  (`core.flops.flops_at`) behind the achieved FLOP/s.

Distinct from `repro_torch.launch.serve.BatchServer`, which serves model
DECODE requests; this server serves optimization ROUNDS.
"""
from __future__ import annotations

import time
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.channel import wire_vector_bytes
from repro_torch.core.draws import Draws, ResidentDraws
from repro_torch.core.flops import flops_at, round_model
from repro_torch.core.rounds import ROUND_DEFS, registry_step_def
from repro_torch.core.types import scalar_hparam
from repro_torch.device import full_precision_matmul, problem_device
from repro_torch.experiments.spec import _REQUIRED, ALGOS, _problem_dtype
from repro_torch.serve.stats import PipelinedReadback, ServeStats


class ClientStream:
    """Host-side residency churn over `num_clients` simulated clients.

    `tick()` advances one round: every client independently flips its
    residency with probability `churn`; if departures would leave fewer than
    `min_resident` clients, random absentees are revived first.  Returns the
    boolean residency mask for the round."""

    def __init__(
        self,
        num_clients: int,
        *,
        churn: float = 0.1,
        min_resident: int | None = None,
        seed: int = 0,
    ) -> None:
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        self.num_clients = num_clients
        self.churn = float(churn)
        self.min_resident = (
            max(1, num_clients // 2) if min_resident is None else int(min_resident)
        )
        if not 1 <= self.min_resident <= num_clients:
            raise ValueError(
                f"min_resident must be in [1, {num_clients}], got {self.min_resident}"
            )
        self._rng = np.random.default_rng(seed)
        self.mask = np.ones(num_clients, dtype=bool)

    def tick(self) -> np.ndarray:
        flips = self._rng.random(self.num_clients) < self.churn
        self.mask = self.mask ^ flips
        short = self.min_resident - int(self.mask.sum())
        if short > 0:
            absent = np.flatnonzero(~self.mask)
            revive = self._rng.choice(absent, size=short, replace=False)
            self.mask[revive] = True
        return self.mask.copy()


def _resolve_hparams(algo: str, hparams: Mapping[str, float] | None, device):
    """Scalar hparam NamedTuple from the ALGOS defaults + overrides."""
    aspec = ALGOS[algo]
    hp = dict(hparams or {})
    unknown = set(hp) - set(aspec.params_cls._fields)
    if unknown:
        raise ValueError(
            f"{algo}: unknown hparams {sorted(unknown)}; "
            f"fields: {list(aspec.params_cls._fields)}"
        )
    vals = {}
    for name in aspec.params_cls._fields:
        if name in hp:
            vals[name] = scalar_hparam(hp[name], device)
        elif aspec.defaults[name] is _REQUIRED:
            raise ValueError(f"{algo}: hparams must provide required hparam {name!r}")
        else:
            vals[name] = scalar_hparam(aspec.defaults[name], device)
    return aspec.params_cls(**vals)


class FedRoundServer:
    """Continuous federated rounds with on-the-fly cohorts from a client stream.

    Supports every rounds-defined algorithm (`core.rounds.ROUND_DEFS`:
    sppm / svrp / svrp_minibatch / deep_svrp).  `run(num_rounds)` keeps the
    server state on the device, queues each round before reading back the
    one `pipeline_depth - 1` rounds earlier, and returns the accumulated
    `ServeStats`.  Repeated `run` calls continue the same trajectory (round
    indices keep counting).  ``draws`` replays a one-trial record (rows
    ``(K,)`` clients or ``(K, b)`` cohorts and ``(K,)`` coins), whose picks
    must be resident; otherwise the server draws from its own generator.

    Pool mode — `FedRoundServer(pool=SessionPool(...))` — serves MANY
    tenants' sessions instead of one churning stream: each served round is
    one pooled tick (`pool.step(1)`), with the same pipelined readback;
    tenants whose horizon runs out are frozen rather than erroring, and
    `run` stops early once no tenant is left running."""

    def __init__(
        self,
        algo: str | None = None,
        problem=None,
        *,
        pool=None,
        hparams: Mapping[str, float] | None = None,
        stream: ClientStream | None = None,
        x0: torch.Tensor | None = None,
        x_star: torch.Tensor | None = None,
        seed: int = 0,
        pipeline_depth: int = 2,
        prox_solver: str = "exact",
        prox_steps: int = 50,
        prox_tol: float = 1e-10,
        batch_clients: int | None = None,
        local_steps: int | None = None,
        channel: str | None = None,
        draws: Draws | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        if pool is not None:
            if algo is not None or problem is not None:
                raise ValueError(
                    "FedRoundServer(pool=...) serves the pool's tenants; "
                    "don't also pass algo/problem (admit tenants to the pool)"
                )
            if pipeline_depth < 1:
                raise ValueError("pipeline_depth must be >= 1")
            self._pool = pool
            self._depth = pipeline_depth
            self._round_idx = 0
            self._comm_served = 0
            self._flops_served = 0.0
            self.stats = ServeStats()
            return
        self._pool = None
        if algo not in ROUND_DEFS:
            raise ValueError(
                f"FedRoundServer serves rounds-defined algorithms "
                f"{sorted(ROUND_DEFS)}; got {algo!r}"
            )
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        dev = problem_device(problem, device)
        full_precision_matmul()
        self.algo = algo
        self.problem = problem
        hp = _resolve_hparams(algo, hparams, dev)
        M = problem.num_clients
        if x0 is None:
            x0 = torch.zeros(problem.dim, dtype=_problem_dtype(problem), device=dev)
        x_star = problem.minimizer() if x_star is None else x_star
        self._stream = stream if stream is not None else ClientStream(M, seed=seed + 1)
        if algo == "svrp_minibatch":
            if batch_clients is None:
                raise ValueError("svrp_minibatch needs batch_clients")
            if self._stream.min_resident < batch_clients:
                raise ValueError(
                    f"cohorts of {batch_clients} need min_resident >= "
                    f"{batch_clients} on the ClientStream "
                    f"(got {self._stream.min_resident})"
                )
        binding: dict[str, Any] = dict(
            prox_solver=prox_solver, prox_steps=prox_steps, prox_tol=prox_tol
        )
        if algo == "deep_svrp":
            binding = {"local_steps": 4 if local_steps is None else local_steps}
        elif batch_clients is not None:
            binding["batch_clients"] = batch_clients
        binding["channel"] = channel
        # Static wire price of one d-vector under this channel: the per-round
        # bytes ledger is comm x this (host int64 — see runner.ledger_bytes).
        self._wire_bytes = wire_vector_bytes(channel, x0.numel(), x0.element_size())
        # Analytic per-round FLOPs model: cumulative FLOPs are exactly
        # recoverable from (round index, cumulative comm) — core.flops.
        self._flops_model = round_model(algo, problem, **binding)
        p = {"svrp": "p", "svrp_minibatch": "p", "deep_svrp": "anchor_prob"}.get(algo)
        self._source = ResidentDraws(
            M, device=dev, p=None if p is None else float(getattr(hp, p)),
            batch_clients=batch_clients if algo == "svrp_minibatch" else None,
            clients=algo != "deep_svrp", coin_dtype=x0.dtype,
            generator=torch.Generator().manual_seed(seed), replay=draws,
        )
        self._sd = registry_step_def(algo, problem, x0, x_star, hp, self._source, **binding)
        self._state = self._sd.init()
        self._round_idx = 0
        self._depth = pipeline_depth
        self.stats = ServeStats()

    @property
    def x(self) -> torch.Tensor:
        """The server's current iterate."""
        return self._sd.final(self._state)

    @property
    def rounds_done(self) -> int:
        return self._round_idx

    def run(self, num_rounds: int) -> ServeStats:
        """Run `num_rounds` continuous rounds; cohorts re-form from the stream
        every round (stream mode) or every running tenant advances one pooled
        round (pool mode); stats readback is pipelined `pipeline_depth` deep."""
        if self._pool is not None:
            return self._run_pool(num_rounds)
        start = time.perf_counter()

        def drain_one(t0: float, round_idx: int, d2: Any, comm: Any) -> None:
            d2_host = float(d2)  # waits until the round's result is ready
            now = time.perf_counter()
            comm_host = int(comm)
            self.stats.record(
                now - t0, now - start, d2_host, comm_host,
                comm_bytes=comm_host * self._wire_bytes,
                flops=float(flops_at(self._flops_model, round_idx, comm_host)),
            )

        readback = PipelinedReadback(self._depth, drain_one)
        for _ in range(num_rounds):
            k = self._round_idx
            self._source.draw(k, self._stream.tick())
            t0 = time.perf_counter()
            self._state, (d2, comm) = self._sd.step(self._state, k)
            self._round_idx += 1
            readback.push(t0, self._round_idx, d2, comm)
        readback.flush()
        return self.stats

    def _run_pool(self, num_rounds: int) -> ServeStats:
        """Pool mode: one pooled tick per served round, aggregate stats.

        The recorded dist^2 is the mean over running lanes' trials after the
        tick; comm/comm_bytes are the cumulative steps SERVED across runs —
        each tick attributes only its own per-lane increments, so the total
        stays monotone when a converged/exhausted tenant's lane freezes."""
        pool = self._pool
        start = time.perf_counter()
        # Per-lane cumulative comm already attributed, seeded from the rounds
        # tenants ran before this call (nothing is in flight yet, so reading
        # it back here stalls no pipeline).
        base = np.zeros((pool.capacity,), dtype=np.int64)
        rounds_base = np.zeros((pool.capacity,), dtype=np.int64)
        for tid in pool.tenant_ids(resident_only=True):
            ses = pool.session(tid)
            if ses.t:
                slot = pool._tenants[tid].slot
                base[slot] = int(ses.comm[:, -1].sum())
                rounds_base[slot] = ses.t
        served = self._comm_served
        flops_served = self._flops_served
        model = pool.flops_model

        def drain_one(t0: float, active: np.ndarray, d2: Any, comm: Any) -> None:
            nonlocal served, flops_served
            d2_host = d2.cpu().numpy()  # waits until the tick's result is ready
            now = time.perf_counter()
            comm_host = comm.cpu().numpy()  # (P, B, 1) cumulative, masked lanes 0
            mean_d2 = float(d2_host[active, :, -1].mean())
            lane_totals = comm_host[:, :, -1].sum(axis=1).astype(np.int64)
            delta = int((lane_totals - base)[active].sum())
            served += delta
            base[active] = lane_totals[active]
            # Exact aggregate FLOPs of this tick: each active lane ran B
            # trials 1 round; inits are charged to trials at round 0 (or at
            # a Catalyst stage boundary), then the refresh count falls out
            # of the comm delta — see core.flops.tick_flops.
            B = comm_host.shape[1]
            if model.stage_rounds:
                init_lanes = active & (rounds_base % model.stage_rounds == 0)
            elif model.comm_init:
                init_lanes = active & (rounds_base == 0)
            else:
                init_lanes = np.zeros_like(active)
            inits = int(np.sum(init_lanes)) * B
            trial_rounds = int(np.sum(active)) * B
            refreshes = 0
            if model.comm_refresh:
                refreshes = max(round(
                    (delta - inits * model.comm_init
                     - trial_rounds * model.comm_base) / model.comm_refresh
                ), 0)
            flops_served += (
                inits * model.init_flops
                + trial_rounds * model.base_flops
                + refreshes * model.refresh_flops
            )
            rounds_base[active] += 1
            self.stats.record(
                now - t0, now - start, mean_d2, served,
                comm_bytes=served * pool.wire_bytes_per_vector, flops=flops_served,
            )

        readback = PipelinedReadback(self._depth, drain_one)
        for _ in range(num_rounds):
            if pool.freeze_exhausted(1) == 0:
                break  # every tenant converged, evicted, or out of horizon
            active = pool.active_mask
            t0 = time.perf_counter()
            d2, comm = pool.step(1)
            self._round_idx += 1
            readback.push(t0, active, d2, comm)
        readback.flush()
        self._comm_served = served
        self._flops_served = flops_served
        return self.stats
