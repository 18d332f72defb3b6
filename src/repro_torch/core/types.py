"""Result and step types of the port's algorithm layer (mirrors `repro.core.types`)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


def _first_hit(dist_sq: torch.Tensor, counts, eps: float) -> torch.Tensor:
    hit = dist_sq <= eps
    idx = torch.argmax(hit.to(torch.int8))  # first True, or 0 if none
    counts = torch.as_tensor(counts, device=dist_sq.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dist_sq.device)
    return torch.where(hit.any(), counts[idx].to(torch.float64), inf)


class StepDef(NamedTuple):
    """One algorithm as an incrementally steppable unit on one binding.

    * ``init() -> state``                       — round-0 state;
    * ``step(state, k) -> (state, (dist_sq, comm))`` — communication round
      ``k``, reading round ``k`` of the draws the unit was bound to
      (deterministic algorithms ignore ``k``);
    * ``final(state) -> x``                     — current iterate.

    The reference's ``schedule`` (its key layout, drawn for the whole
    horizon because ``split`` is not prefix-stable) is the record itself:
    the port's draws are a `core.draws.Draws` bound at construction, drawn
    once for the whole horizon, and round ``k`` reads its row ``k``.  So a
    session that binds the horizon's record at open and steps rounds
    ``[t, t + n)`` a chunk at a time (`step_rounds`) computes the first
    columns of `scan_step_def` over the same record, by construction; the
    record is never extended, and a session refuses to step past it.
    `scan_step_def` runs ``num_steps`` rounds from `init`, as the
    reference's ``lax.scan(sd.step, sd.init(), keys)`` does.
    """

    init: Callable[[], Any]
    step: Callable[[Any, int], tuple]
    final: Callable[[Any], Any]


class RunResult(NamedTuple):
    """Trajectory of a federated optimization run.

    ``comm`` is the paper's Section-4.2 count (one vector exchanged between the
    server and one client = one step); ``comm_bytes`` is the int64 wire-bytes
    ledger the entry points attach on the host, outside the round loop, so it
    cannot overflow at real model sizes.
    """

    dist_sq: torch.Tensor  # (K,) squared distance to x_star after each round
    comm: torch.Tensor  # (K,) cumulative communication steps after each round
    x_final: torch.Tensor  # final iterate
    comm_bytes: np.ndarray | None = None  # (K,) cumulative wire bytes (int64)

    def comm_to_accuracy(self, eps: float) -> torch.Tensor:
        """First cumulative-communication count at which dist_sq <= eps
        (+inf if the run never reached eps)."""
        return _first_hit(self.dist_sq, self.comm, eps)

    def bytes_to_accuracy(self, eps: float) -> torch.Tensor:
        """First cumulative wire-bytes count at which dist_sq <= eps (+inf if
        never reached; requires the entry point to have attached the ledger)."""
        if self.comm_bytes is None:
            raise ValueError(
                "this RunResult carries no bytes ledger — run it through "
                "run_batch, which attaches comm_bytes"
            )
        return _first_hit(self.dist_sq, self.comm_bytes, eps)


def step_rounds(sd: StepDef, state, start: int, n: int) -> tuple:
    """Rounds ``start, ..., start + n - 1`` of ``sd`` from ``state``:
    ``(state, (dist_sq, comm))``, the per-round outputs stacked on a last
    (round) axis, ``(n,)`` for one trial and ``(B, n)`` for a lane batch."""
    d2s, comms = [], []
    for k in range(start, start + n):
        state, (d2, comm) = sd.step(state, k)
        d2s.append(d2)
        comms.append(comm)
    return state, (torch.stack(d2s, dim=-1), torch.stack(comms, dim=-1))


def scan_step_def(sd: StepDef, num_steps: int) -> RunResult:
    """``num_steps`` rounds of ``sd`` from its `init` (`step_rounds` from
    round 0) as a `RunResult`."""
    state, (d2, comm) = step_rounds(sd, sd.init(), 0, num_steps)
    return RunResult(d2, comm, sd.final(state))


def scalar_hparam(v, device) -> torch.Tensor:
    """A driver's float hparam as a 0-d float64 tensor (the reference's x64 scalar)."""
    return torch.as_tensor(v, dtype=torch.float64, device=device)
