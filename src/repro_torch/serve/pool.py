"""Multi-tenant session pool: many federations stepped together each tick.

Port of `repro.serve.pool`.  A `FedSession` keeps one sweep on the device
and steps it a chunk at a time, so N concurrently open sessions cost N
rounds' launches a round.  `SessionPool` holds up to `capacity` tenants'
sessions (same algorithm and problem SHAPES; independent problems,
hyperparameters, seeds, horizons and `stop_eps`) and advances all of them
with one `step(n)`:

    pool = SessionPool(capacity=8)
    a = pool.admit("svrp", problem_a, grid={"eta": 1e-2, "p": 0.1},
                   seeds=4, num_steps=500)
    b = pool.admit("svrp", problem_b, grid={"eta": 3e-3, "p": 0.1},
                   seeds=4, num_steps=200, stop_eps=1e-9)
    pool.step(50)          # both tenants 50 rounds
    pool.result(a)         # per-tenant BatchResult, == standalone session

Two tick forms, chosen once by the first admit:

* **stacked** (`core.rounds.pool_stacks`: sppm, svrp and svrp_minibatch on
  the plain quadratic) — the running tenants' lanes are ONE ``(R B,)``-lane
  registry round (`core.rounds.registry_pool_step_def`): their problems'
  clients stacked into one problem, their states, hparams and x_star
  concatenated on the lane axis, their records' windows side by side with
  the host refresh masks OR-ed, so a tick costs one round's launches
  whatever the number of tenants.  The binding is made at a lifecycle event
  (admit, evict, freeze, the first step) and reused until the next;
* **tenant by tenant** — everything else (Catalyst, the baselines,
  composite, DeepSVRP, other problem families): each running tenant's
  session steps in turn within the tick.

Either way a pooled lane equals its standalone `FedSession` (to rounding:
<= 1e-5, with `comm` and `comm_bytes` integer-exact; held by
tests/test_torch_pool.py).  A tenant admitted mid-run starts its own record
at round 0.  Frozen (``stop_eps`` reached, or horizon exhausted) and empty
lanes are not stepped at all: their rows of a tick's pooled output are zero
and nothing reaches any tenant's stats or bytes.  `FedRoundServer(pool=...)`
drives a pool tick by tick with the server's pipelined readback.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.channel import wire_vector_bytes
from repro_torch.core.draws import Draws
from repro_torch.core.rounds import pool_stacks, registry_pool_step_def
from repro_torch.core.types import step_rounds
from repro_torch.experiments.runner import BatchResult
from repro_torch.experiments.spec import as_runspec, check_pool_entry, pool_entry_signature
from repro_torch.serve.session import _REGISTRY_BINDING, FedSession


def _cat_lanes(states: list):
    """Round states (tensors with a leading lane axis, nested in tuples)
    concatenated on the lane axis."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(states)
    parts = [_cat_lanes(list(p)) for p in zip(*states)]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def _split_lanes(state, n: int) -> list:
    """The inverse of `_cat_lanes` over ``n`` equal lane groups."""
    if isinstance(state, torch.Tensor):
        return list(torch.tensor_split(state, n))
    per = [_split_lanes(p, n) for p in state]
    make = (lambda parts: type(state)(*parts)) if hasattr(state, "_fields") else tuple
    return [make([p[i] for p in per]) for i in range(n)]


@dataclasses.dataclass
class PoolTenant:
    """One admitted session's pool-side bookkeeping (internal)."""

    id: int
    slot: int
    session: FedSession
    stop_eps: float | None = None
    frozen: bool = False  # stop_eps reached, or frozen by the server
    evicted: bool = False
    reached: np.ndarray | None = None  # (B,) trials at or below stop_eps so far

    @property
    def running(self) -> bool:
        return not self.frozen and not self.evicted


class _Binding:
    """The stacked tick's binding: the running tenants in slot order, their
    pooled step definition, their concatenated state, and the rounds stepped
    since it was made (the row its record window is at)."""

    def __init__(self, tenants: list, sd, state):
        self.tenants, self.sd, self.state, self.rounds = tenants, sd, state, 0


class SessionPool:
    """Up to `capacity` tenants' sessions stepped together each tick.

    See the module docstring for the contract.  `admit` accepts exactly what
    `open_session` accepts (a `RunSpec` or the keyword style) and checks the
    tenant against the pool's signature (`experiments.spec.pool_entry_signature`):
    algorithm, round-body static config, trial count and problem / x0 /
    x_star shapes must match the first admit; hyperparameters, problems,
    seeds, horizons and `stop_eps` vary freely."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._slots: list[PoolTenant | None] = [None] * capacity
        self._tenants: dict[int, PoolTenant] = {}  # every tenant ever admitted
        self._next_id = 0
        self._signature: tuple | None = None
        self._algo: str | None = None
        self._binding_cfg: dict = {}
        self.stacked = False
        self._bound: _Binding | None = None

    # ------------------------------------------------------------- admission
    def admit(
        self,
        algo,
        problem=None,
        grid: Mapping[str, Any] | None = None,
        seeds: int | Sequence[int] = 1,
        *,
        stop_eps: float | None = None,
        x0=None,
        x_star=None,
        stepsize: str | None = None,
        target_eps: float = 1e-6,
        theory_constants: Any = None,
        draws: Draws | None = None,
        device=None,
        **static,
    ) -> int:
        """Admit one tenant into a free slot; returns its tenant id.  Its
        session draws (or takes) its own record, from round 0."""
        spec = as_runspec(
            algo, grid=grid, seeds=seeds, x0=x0, x_star=x_star,
            stepsize=stepsize, target_eps=target_eps,
            theory_constants=theory_constants, substrate=None, static=static,
        )
        if spec.substrate not in (None, "batched"):
            raise ValueError(
                f"SessionPool packs the batched substrate only; "
                f"got substrate={spec.substrate!r}"
            )
        spec = dataclasses.replace(spec, substrate="batched")
        session = FedSession(spec, problem, draws=draws, device=device)
        sig = pool_entry_signature(
            session._algo, session._cfg, session.num_trials,
            session._problem, session._x0, session._x_star,
        )
        if self._signature is None:
            self._install_signature(sig, session)
        else:
            check_pool_entry(self._signature, sig)
        slot = next((i for i, t in enumerate(self._slots) if t is None), None)
        if slot is None:
            raise ValueError(f"pool is full ({self.capacity} slots); evict a tenant first")
        self._unbind()
        tenant = PoolTenant(id=self._next_id, slot=slot, session=session, stop_eps=stop_eps,
                            reached=np.zeros(session.num_trials, dtype=bool))
        self._next_id += 1
        self._slots[slot] = tenant
        self._tenants[tenant.id] = tenant
        return tenant.id

    def _install_signature(self, sig: tuple, session: FedSession) -> None:
        from repro_torch.core.flops import round_model

        self._signature = sig
        self._algo = session._algo
        self._binding_cfg = {k: session._cfg[k] for k in _REGISTRY_BINDING if k in session._cfg}
        self.stacked = pool_stacks(self._algo, session._problem)
        x0 = session._x0
        self.wire_bytes_per_vector = wire_vector_bytes(
            session._cfg.get("channel"), x0.numel(), x0.element_size())
        # The analytic per-round FLOPs model (core.flops), valid for every
        # tenant: admission requires the (algo, statics, shapes) it reads.
        self.flops_model = round_model(
            self._algo, session._problem,
            **{k: v for k, v in session._cfg.items() if k != "prox_R"},
        )

    # -------------------------------------------------------------- stepping
    def _running(self) -> list[PoolTenant]:
        return [t for t in self._slots if t is not None and t.running]

    def _bind(self, running: list[PoolTenant]) -> _Binding:
        """The stacked binding of ``running`` from their sessions' states,
        over their records' windows up to the nearest horizon."""
        ses = [t.session for t in running]
        rounds = min(s.horizon - s.t for s in ses)
        windows = [s.draws.window(s.t, rounds).to(s._device) for s in ses]
        sd = registry_pool_step_def(
            self._algo, [s._problem for s in ses], [s._x_star for s in ses],
            [s._hp for s in ses], windows, x0=ses[0]._x0, **self._binding_cfg,
        )
        return _Binding(running, sd, _cat_lanes([s._state[0] for s in ses]))

    def _unbind(self) -> None:
        """Write the stacked state back into the sessions and drop the
        binding (before any lifecycle event)."""
        if self._bound is not None:
            self._write_back()
            self._bound = None

    def _write_back(self) -> None:
        b = self._bound
        for t, piece in zip(b.tenants, _split_lanes(b.state, len(b.tenants))):
            t.session._state = [piece]

    def step(self, n: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """Advance every running tenant `n` rounds; returns the pooled
        `(P, B, n)` dist-sq and cumulative-comm blocks (rows of frozen and
        empty slots zero).  Raises the session's past-horizon error,
        prefixed with the tenant id, if a running tenant's record cannot
        cover `n` more rounds; then nothing advances."""
        if n < 1:
            raise ValueError(f"step(n={n}): n must be >= 1")
        running = self._running()
        if not running:
            raise ValueError(
                "pool has no running tenants — admit() one (or un-freeze via "
                "evict+admit) before stepping"
            )
        for t in running:
            try:
                t.session.check_horizon(n)
            except ValueError as e:
                raise ValueError(f"pool tenant {t.id}: {e}") from None
        if self.stacked:
            if self._bound is None:
                self._bound = self._bind(running)
            b = self._bound
            b.state, (d2, comm) = step_rounds(b.sd, b.state, b.rounds, n)
            b.rounds += n
            blocks = list(zip(torch.tensor_split(d2, len(running)),
                              torch.tensor_split(comm, len(running))))
            for t, (d2_t, comm_t) in zip(running, blocks):
                t.session.record(d2_t, comm_t)
            if [t.slot for t in running] == list(range(self.capacity)):
                # Every slot running, in order: the stacked outputs are the
                # pooled ones, as views.
                d2_out, comm_out = (v.reshape(self.capacity, -1, n) for v in (d2, comm))
            else:
                d2_out, comm_out = self._pooled(running, blocks, n)
        else:
            blocks = [t.session.step(n) for t in running]
            d2_out, comm_out = self._pooled(running, blocks, n)
        for t, (d2_t, _) in zip(running, blocks):
            if t.stop_eps is not None:
                t.reached |= (d2_t <= t.stop_eps).any(dim=1).cpu().numpy()
                if t.reached.all():
                    self._freeze(t)
        return d2_out, comm_out

    def _pooled(self, running, blocks, n: int):
        """The tick's ``(P, B, n)`` outputs, zero in every slot not stepped."""
        d2_0, comm_0 = blocks[0]
        B = d2_0.shape[0]
        slots = torch.tensor([t.slot for t in running], device=d2_0.device)
        d2_out = torch.zeros((self.capacity, B, n), dtype=d2_0.dtype, device=d2_0.device)
        comm_out = torch.zeros((self.capacity, B, n), dtype=comm_0.dtype, device=comm_0.device)
        d2_out.index_copy_(0, slots, torch.stack([d for d, _ in blocks]))
        comm_out.index_copy_(0, slots, torch.stack([c for _, c in blocks]))
        return d2_out, comm_out

    def _freeze(self, t: PoolTenant) -> None:
        self._unbind()
        t.frozen = True

    def freeze_exhausted(self, n: int = 1) -> int:
        """Freeze every running tenant whose record cannot cover `n` more
        rounds (the serving loop's graceful alternative to `step`'s
        past-horizon error); returns how many tenants remain running."""
        count = 0
        for t in self._running():
            if t.session.t + n > t.session.horizon:
                self._freeze(t)
            else:
                count += 1
        return count

    # ------------------------------------------------------------- lifecycle
    def evict(self, tenant_id: int) -> FedSession:
        """Release a tenant's slot; its `FedSession`, state written back, is
        returned fully usable on its own."""
        t = self._require(tenant_id)
        if t.evicted:
            raise ValueError(f"tenant {tenant_id} already evicted")
        self._unbind()
        t.evicted = True
        self._slots[t.slot] = None
        return t.session

    def session(self, tenant_id: int) -> FedSession:
        """The tenant's `FedSession`, state synced from the pool."""
        t = self._require(tenant_id)
        if self._bound is not None and t in self._bound.tenants:
            self._write_back()
        return t.session

    def result(self, tenant_id: int) -> BatchResult:
        """The tenant's rounds-so-far as a `BatchResult` (equal to its
        standalone session's, per tests/test_torch_pool.py)."""
        return self.session(tenant_id).result()

    def _require(self, tenant_id: int) -> PoolTenant:
        if tenant_id not in self._tenants:
            raise KeyError(f"unknown tenant id {tenant_id}; known: {sorted(self._tenants)}")
        return self._tenants[tenant_id]

    # ------------------------------------------------------------ inspection
    @property
    def num_resident(self) -> int:
        return sum(t is not None for t in self._slots)

    @property
    def num_running(self) -> int:
        return len(self._running())

    @property
    def active_mask(self) -> np.ndarray:
        """(P,) — which slots the next tick advances."""
        return np.asarray([t is not None and t.running for t in self._slots], dtype=bool)

    def tenant_ids(self, *, resident_only: bool = False) -> list[int]:
        if resident_only:
            return sorted(t.id for t in self._slots if t is not None)
        return sorted(self._tenants)

    def is_frozen(self, tenant_id: int) -> bool:
        return self._require(tenant_id).frozen

    @property
    def total_rounds(self) -> int:
        """Rounds executed across every tenant ever admitted."""
        return sum(t.session.t for t in self._tenants.values())

    @property
    def total_comm_bytes(self) -> int:
        """Wire bytes across every tenant ever admitted (each tenant's own
        int64 ledger, summed over trials)."""
        return sum(int(t.session.comm_bytes[:, -1].sum())
                   for t in self._tenants.values() if t.session.t)

    @property
    def total_flops(self) -> float:
        """Analytic FLOPs across every tenant ever admitted (`core.flops`)."""
        return sum(float(t.session.flops[:, -1].sum())
                   for t in self._tenants.values() if t.session.t)
