"""Result type of the port's algorithm layer (mirrors `repro.core.types`)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _first_hit(dist_sq: torch.Tensor, counts, eps: float) -> torch.Tensor:
    hit = dist_sq <= eps
    idx = torch.argmax(hit.to(torch.int8))  # first True, or 0 if none
    counts = torch.as_tensor(counts, device=dist_sq.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dist_sq.device)
    return torch.where(hit.any(), counts[idx].to(torch.float64), inf)


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
