"""l2-regularized logistic regression: the non-quadratic validation problem.

Port of `repro.problems.logistic`.  `make_a9a_like_problem` re-synthesizes a
dataset matched to LIBSVM a9a's published statistics (123 binary features,
~13.9 nonzeros/row, n_pool = 32561) with labels from a planted logistic model;
clients subsample the pool i.i.d. as in the paper.  The generator is the
reference's numpy code, so the same seed gives bit-identical arrays.

The local prox and the full-batch `minimizer` use the GUARDED Newton of
`repro_torch.core.prox` (backtracking plus a gradient-norm early exit).
Oracles are batched over the shape of ``m`` like the quadratic problem's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.prox import prox_newton
from repro_torch.device import resolve_device


def _sigmoid(t: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.tanh(0.5 * t) + 1.0)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _mtv(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A^T w for (..., n, d) blocks and (..., n) weights."""
    return torch.matmul(A.transpose(-1, -2), w.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class LogisticProblem:
    """f_m(x) = (1/n) sum_i log(1 + exp(-y_i z_i'x)) + lam/2 ||x||^2, y in {-1,+1}."""

    Z: torch.Tensor  # (M, n, d)
    y: torch.Tensor  # (M, n), +-1
    lam: float

    # Every tensor is client-major and zero pads are benign: shard="clients"
    # applies (problems.client_shard).
    client_shardable = True

    @property
    def num_clients(self) -> int:
        return self.Z.shape[0]

    @property
    def dim(self) -> int:
        return self.Z.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.Z.device

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.dim, dtype=self.Z.dtype, device=self.Z.device)

    # --- oracles -----------------------------------------------------------------
    def loss(self, m, x):
        t = self.y[m] * _mv(self.Z[m], x)
        return torch.logaddexp(torch.zeros_like(t), -t).mean(-1) + 0.5 * self.lam * (x * x).sum(-1)

    def grad(self, m, x):
        Z_m, y_m = self.Z[m], self.y[m]
        t = y_m * _mv(Z_m, x)
        w = -y_m * _sigmoid(-t)  # d/dt log(1+e^-t) = -sigmoid(-t)
        return _mtv(Z_m, w) / Z_m.shape[-2] + self.lam * x

    def full_loss(self, x):
        t = self.y * torch.einsum("mnd,...d->...mn", self.Z, x)
        return torch.logaddexp(torch.zeros_like(t), -t).mean((-2, -1)) + 0.5 * self.lam * (x * x).sum(-1)

    def full_grad(self, x):
        t = self.y * torch.einsum("mnd,...d->...mn", self.Z, x)
        w = -self.y * _sigmoid(-t)
        M, n, _ = self.Z.shape
        return torch.einsum("mnd,...mn->...d", self.Z, w) / (M * n) + self.lam * x

    def hessian(self, m, x):
        Z_m = self.Z[m]
        t = self.y[m] * _mv(Z_m, x)
        s = _sigmoid(t) * _sigmoid(-t)
        H = torch.matmul((Z_m * s.unsqueeze(-1)).transpose(-1, -2), Z_m)
        return H / Z_m.shape[-2] + self.lam * self._eye()

    def local_oracle(self, m):
        """(grad_fn, hess_fn) of client(s) m on the label-signed rows
        A = y_m * Z_m, gathered once per solve."""
        A = self.Z[m] * self.y[m].unsqueeze(-1)
        n = A.shape[-2]
        eye = self.lam * self._eye()

        def grad_fn(x):
            u = _sigmoid(-_mv(A, x))  # sigmoid of minus-margins
            return -_mtv(A, u) / n + self.lam * x

        def hess_fn(x):
            t = _mv(A, x)
            s = _sigmoid(t) * _sigmoid(-t)
            return torch.matmul((A * s.unsqueeze(-1)).transpose(-1, -2), A) / n + eye

        return grad_fn, hess_fn

    def prox(self, m, z, eta, newton_steps: int = 50, tol: float = 1e-11):
        """prox_{eta f_m}(z) via GUARDED Newton on the strongly convex subproblem."""
        grad_fn, hess_fn = self.local_oracle(m)
        return prox_newton(grad_fn, hess_fn, z, eta, max_steps=newton_steps, tol=tol)

    def shifted(self, gamma, y_anchor: torch.Tensor) -> "ShiftedLogisticProblem":
        """Catalyst subproblem; ``gamma`` a float, or per lane (``S``) with
        ``y_anchor`` ``S + (d,)``."""
        return ShiftedLogisticProblem(base=self, gamma=gamma, anchor=y_anchor)

    shifted_lanes = shifted

    # --- measured constants (the paper reports measured L, delta) -----------------
    def smoothness(self) -> torch.Tensor:
        """L <= lambda_max((1/(4 M n)) sum Z'Z) + lam — the standard bound."""
        M, n, _ = self.Z.shape
        G = torch.einsum("mni,mnj->ij", self.Z, self.Z) / (M * n)
        return 0.25 * torch.linalg.eigvalsh(G)[-1] + self.lam

    def smoothness_max(self) -> torch.Tensor:
        """max_m L_m <= max_m lambda_max(Z_m'Z_m/(4 n)) + lam."""
        n = self.Z.shape[1]
        G = torch.matmul(self.Z.transpose(-1, -2), self.Z) / (4.0 * n)
        return torch.linalg.eigvalsh(G)[:, -1].max() + self.lam

    def strong_convexity(self) -> float:
        return self.lam

    def _client_hessians(self, x):
        ms = torch.arange(self.num_clients, device=self.Z.device)
        return self.hessian(ms, x.expand(self.num_clients, self.dim))

    def similarity_at(self, x) -> torch.Tensor:
        """Measured delta(x): sqrt(lambda_max((1/M) sum (H_m(x) - Hbar(x))^2))."""
        H = self._client_hessians(x)
        E = H - H.mean(dim=0, keepdim=True)
        S = torch.matmul(E, E).mean(dim=0)
        return torch.sqrt(torch.linalg.eigvalsh(S)[-1])

    def similarity_max_at(self, x) -> torch.Tensor:
        """Per-client delta(x): max_m ||H_m(x) - Hbar(x)||_op."""
        H = self._client_hessians(x)
        E = H - H.mean(dim=0, keepdim=True)
        return torch.linalg.eigvalsh(E).abs().max()

    def minimizer(self, steps: int = 200, tol: float = 1e-12) -> torch.Tensor:
        """Full-batch guarded Newton to machine precision (reference x_*)."""

        def full_hess(x):
            return self._client_hessians(x).mean(dim=0)

        x0 = torch.zeros(self.dim, dtype=self.Z.dtype, device=self.Z.device)
        # The full objective is its own prox subproblem as eta -> inf.
        return prox_newton(
            self.full_grad, full_hess, x0, 1e12, max_steps=steps, tol=tol
        )


@dataclasses.dataclass(frozen=True, eq=False)
class ShiftedLogisticProblem:
    """Catalyst subproblem h_t: adds gamma/2 ||x - anchor||^2 to every client.
    ``gamma`` is a float, or a per-lane ``S`` tensor (anchor ``S + (d,)``)
    whose lane s shifts rows ``S + (d,)`` of lane s."""

    base: LogisticProblem
    gamma: float | torch.Tensor
    anchor: torch.Tensor

    def _gamma(self, trailing: int):
        g = self.gamma
        return g.reshape(g.shape + (1,) * trailing) if isinstance(g, torch.Tensor) else g

    @property
    def num_clients(self):
        return self.base.num_clients

    @property
    def dim(self):
        return self.base.dim

    @property
    def device(self) -> torch.device:
        return self.base.device

    def grad(self, m, x):
        return self.base.grad(m, x) + self._gamma(1) * (x - self.anchor)

    def full_grad(self, x):
        return self.base.full_grad(x) + self._gamma(1) * (x - self.anchor)

    def hessian(self, m, x):
        return self.base.hessian(m, x) + self._gamma(2) * self.base._eye()

    def local_oracle(self, m):
        grad0, hess0 = self.base.local_oracle(m)
        shift_eye = self._gamma(2) * self.base._eye()

        def grad_fn(x):
            return grad0(x) + self._gamma(1) * (x - self.anchor)

        def hess_fn(x):
            return hess0(x) + shift_eye

        return grad_fn, hess_fn

    def prox(self, m, z, eta, newton_steps: int = 50, tol: float = 1e-11):
        grad_fn, hess_fn = self.local_oracle(m)
        return prox_newton(grad_fn, hess_fn, z, eta, max_steps=newton_steps, tol=tol)


def make_a9a_like_problem(
    num_clients: int,
    n_per_client: int = 2000,
    lam: float = 0.1,
    n_pool: int = 32561,
    dim: int = 123,
    nnz_per_row: int = 14,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device | None = None,
) -> LogisticProblem:
    """a9a-statistics-matched synthetic pool + i.i.d. per-client subsampling."""
    rng = np.random.default_rng(seed)
    col_p = 1.0 / np.arange(1, dim + 1) ** 0.8
    col_p /= col_p.sum()
    # Without-replacement column sampling per row via the Gumbel-top-k trick.
    if nnz_per_row >= dim:
        pool = np.ones((n_pool, dim), dtype=np.float64)
    else:
        gumbel = rng.gumbel(size=(n_pool, dim))
        cols = np.argpartition(-(np.log(col_p)[None, :] + gumbel), nnz_per_row, axis=1)
        pool = np.zeros((n_pool, dim), dtype=np.float64)
        np.put_along_axis(pool, cols[:, :nnz_per_row], 1.0, axis=1)
    x_true = rng.standard_normal(dim) / np.sqrt(nnz_per_row)
    logits = pool @ x_true
    y_pool = np.where(rng.uniform(size=n_pool) < 1.0 / (1.0 + np.exp(-logits)), 1.0, -1.0)

    idx = rng.integers(0, n_pool, size=(num_clients, n_per_client))
    dev = resolve_device(device)
    return LogisticProblem(
        Z=torch.as_tensor(pool[idx], dtype=dtype, device=dev),
        y=torch.as_tensor(y_pool[idx], dtype=dtype, device=dev),
        lam=lam,
    )
