"""Client-axis sharding support: padding, the support contract, the rank's
block and the rank-local problem view.

Port of `repro.problems.client_shard`.  ``run_batch(shard="clients")`` lays
the CLIENT axis over the ranks of a process group (`launch.mesh`): rank r
holds clients ``[r M_local, (r + 1) M_local)`` of the problem padded to
``size x M_local`` clients.  A problem opts in by setting the class
attribute ``client_shardable = True``, a contract with three clauses:

* every tensor field of the (frozen dataclass) problem is client-major,
  shape ``(M, ...)``, so one rule cuts all of them into blocks (data, DP
  noise shifts, anything added later);
* zero-padded client rows are benign oracle inputs (finite gradients, a
  solvable prox): padding appends zero rows, which the substrate's
  ``valid`` mask keeps out of every result;
* per-client oracles touch only the indexed client's rows, so a rank's
  block answers them bit for bit as the whole problem does.

`QuadraticProblem` and `LogisticProblem` (and their DP-ERM subclasses,
whose ``dp_shift`` is client-major noise) declare support.  Problems that
do not are refused before anything runs.

`ClientShardedProblem` is the rank-local VIEW for the algorithms outside
`core.rounds.ROUND_DEFS` (sgd, svrg, scaffold, dane, acc_extragradient,
composite, catalyzed_svrp): their unchanged drivers run against it, and it
answers each per-client oracle on the owner rank, zeros elsewhere, summed
by one `all_reduce` a call (the rounds-defined algorithms' binding,
`core.rounds.ClientShardedOps`, pays one a round).
"""
from __future__ import annotations

import copy
import dataclasses

import torch


def check_client_shardable(problem) -> None:
    """The gate for ``shard='clients'``, with the reference's text."""
    if not getattr(problem, "client_shardable", False):
        raise ValueError(
            f"shard='clients' is not supported for {type(problem).__name__}: "
            "the problem does not declare client-axis sharding.  Declare it by "
            "setting the class attribute `client_shardable = True` once every "
            "array leaf is client-major (M, ...) and zero-padded client rows "
            "are benign oracle inputs (see repro.problems.client_shard)."
        )


def _client_fields(problem) -> dict[str, torch.Tensor]:
    """The problem's tensor fields, each checked to be client-major."""
    M = problem.num_clients
    fields = {f.name: getattr(problem, f.name) for f in dataclasses.fields(problem)}
    fields = {k: v for k, v in fields.items() if isinstance(v, torch.Tensor)}
    if any(t.shape[:1] != (M,) for t in fields.values()):
        raise ValueError(
            f"client_shardable problem {type(problem).__name__} has array "
            f"leaves that are not client-major (expected leading axis {M}): "
            "the client-axis sharding contract is violated"
        )
    return fields


def client_block(problem, lo: int, hi: int, device=None):
    """Clients ``[lo, hi)`` of ``problem`` as a problem of its own, with zero
    rows past its last client (the pads), every tensor a contiguous copy on
    ``device`` (default: the problem's): the rank's share of the client
    axis, the counterpart of shard_map's split."""
    M = problem.num_clients

    def block(t: torch.Tensor) -> torch.Tensor:
        rows = t[min(lo, M):min(hi, M)]
        pad = rows.new_zeros((hi - lo - rows.shape[0],) + t.shape[1:])
        return torch.cat([rows, pad]).contiguous().to(device or t.device)

    return dataclasses.replace(problem, **{k: block(t) for k, t in _client_fields(problem).items()})


def pad_clients(problem, total: int):
    """Zero-pad every client-major tensor of ``problem`` to ``total``
    clients, so the axis divides the ranks.  Pads are masked out of every
    result by the substrate's ``valid`` mask and never sampled (draws use
    the true M)."""
    _client_fields(problem)
    if total == problem.num_clients:
        return problem
    return client_block(problem, 0, total)


# Planted fault for chip_smoke.py's checks: the valid mask counts the pads
# as clients (False in every real run).
_VALID_COUNTS_PADS = False


def shard_clients(problem, mesh, device=None):
    """This rank's block of ``problem`` padded to a multiple of the mesh's
    size, and the replicated ``(M_pad,)`` host mask ``valid`` of the true
    clients (the pads lie at the end of the padded axis)."""
    M = problem.num_clients
    M_local = -(-M // mesh.size)
    lo = mesh.rank * M_local
    local = client_block(problem, lo, lo + M_local, device)
    valid = torch.arange(M_local * mesh.size) < (M_local * mesh.size if _VALID_COUNTS_PADS else M)
    return local, valid


class ClientShards:
    """What a rank knows of the client axis: its block's offset and size,
    its count of true clients (a prefix of the block, since the pads lie at
    the end of the padded axis), the count of true clients ``valid`` marks
    over every rank (the divisor of each client mean), and the block's true
    clients as a problem of their own (None when the block holds only
    pads), whose ``full_grad`` times their count is the block's sum of
    client gradients."""

    def __init__(self, local, valid: torch.Tensor, mesh):
        self.mesh = mesh
        self.M_local = local.num_clients
        self.offset = mesh.rank * self.M_local
        self.n_valid = int(valid[self.offset:self.offset + self.M_local].sum())
        self.count = int(valid.sum())
        self.valid_block = client_block(local, 0, self.n_valid) if self.n_valid else None

    def local_index(self, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Global client ids -> (the clamped local row, does this rank own it)."""
        local = m - self.offset
        resident = (local >= 0) & (local < self.M_local)
        return local.clamp(0, self.M_local - 1), resident

    def assemble(self, value: torch.Tensor, resident: torch.Tensor) -> torch.Tensor:
        """Owner rows plus zeros from every other rank, summed by one
        `all_reduce`: exact, since only the owner adds anything."""
        mask = resident.reshape(resident.shape + (1,) * (value.ndim - resident.ndim))
        return self.mesh.all_reduce(torch.where(mask, value, torch.zeros_like(value)))

    def mean(self, block_sum: torch.Tensor) -> torch.Tensor:
        """A client mean from each rank's sum over its true clients: one
        `all_reduce`, divided by the count of true clients."""
        return self.mesh.all_reduce(block_sum.contiguous()) / self.count

    def full_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The mean client gradient at ``x`` (trial-shared ``(d,)`` or lanes)."""
        if self.valid_block is None:
            return self.mean(torch.zeros_like(x))
        return self.mean(self.valid_block.full_grad(x) * self.n_valid)

    def row_mean(self, y: torch.Tensor) -> torch.Tensor:
        """The client mean of full-participation rows ``S + (M_local, d)``
        of this block: S + (d,)."""
        return self.mean(y[..., :self.n_valid, :].sum(dim=-2))

    def shifted(self, fn) -> "ClientShards":
        """The same shards over ``fn`` of the true clients' problem
        (Catalyst's shift)."""
        out = copy.copy(self)
        out.valid_block = None if self.valid_block is None else fn(self.valid_block)
        return out


class ClientShardedProblem:
    """Rank-local view of a client-sharded problem.

    Presents the whole problem's oracle surface over this rank's resident
    block: a per-client oracle is computed by the owner (its clamped local
    row), zeroed elsewhere and summed by one `all_reduce`; the full gradient
    is the block's sum over its true clients, summed by one `all_reduce` and
    divided by the global M.  ``num_clients`` is the global M, so sampling
    and the communication accounting inside the unchanged drivers are those
    of the other substrates.  The replicated values every rank receives
    decide every branch (a Newton early exit reads the summed gradient), so
    the ranks issue the same collectives.

    Forwards no raw data (``A``/``b``/``Z``/``y``): code that special-cases
    a data layout (`core.baselines._surrogate_min`'s closed-form quadratic
    solve) takes its oracle-only route, which this view answers exactly."""

    def __init__(self, local, valid: torch.Tensor, mesh, num_clients: int):
        self._local = local
        self._shards = ClientShards(local, valid, mesh)
        self.num_clients = int(num_clients)

    @property
    def dim(self) -> int:
        return self._local.dim

    @property
    def device(self) -> torch.device:
        return self._local.device

    def _owned(self, fn, m, *args):
        local, resident = self._shards.local_index(m)
        return self._shards.assemble(fn(local, *args), resident)

    def grad(self, m, x):
        return self._owned(self._local.grad, m, x)

    def hessian(self, m, x):
        return self._owned(self._local.hessian, m, x)

    def full_grad(self, x):
        return self._shards.full_grad(x)

    def prox(self, m, z, eta, *args, **kwargs):
        return self._owned(lambda i, v: self._local.prox(i, v, eta, *args, **kwargs), m, z)

    def prox_factors(self):
        """Per-client solver state of the RESIDENT block only (the spectral
        eigendecomposition factorizes M_local matrices a rank)."""
        return self._local.prox_factors()

    def prox_spectral(self, m, z, eta, factors):
        return self._owned(lambda i, v: self._local.prox_spectral(i, v, eta, factors), m, z)

    def _view(self, fn) -> "ClientShardedProblem":
        out = copy.copy(self)
        out._local, out._shards = fn(self._local), self._shards.shifted(fn)
        return out

    def shifted(self, gamma, y):
        """Catalyst's shift is per client, so the shifted view wraps the
        shifted block (same mask, same mesh)."""
        return self._view(lambda p: p.shifted(gamma, y))

    def shifted_lanes(self, gamma, y):
        """Catalyst's per-lane shift (`QuadraticProblem.shifted_lanes`) of the block."""
        return self._view(lambda p: p.shifted_lanes(gamma, y))
