"""Finite-sum quadratic problems with controlled second-order similarity.

Port of `repro.problems.quadratic`.  Per-client losses are quadratics

    f_m(x) = 0.5 x^T A_m x - b_m^T x,

with A_m >= mu I, so every quantity the paper uses has a closed form (exact
prox, minimizer, smoothness, strong convexity and similarity constants).

Oracles are batched over leading axes: ``m`` is an integer tensor of any
shape ``S`` and ``x`` has shape ``S + (d,)`` (a 0-d ``m`` with a ``(d,)``
``x`` is one client).  The generators are the reference's numpy code, so the
same seed gives bit-identical arrays.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from repro_torch.device import resolve_device


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., d, d) x (..., d) -> (..., d)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _per_lane(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-lane (S,) parameter as a multiplier for (S, d) rows."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.unsqueeze(-1) if v.ndim else v


@dataclasses.dataclass(frozen=True, eq=False)
class QuadraticProblem:
    """Finite-sum quadratic  f(x) = (1/M) sum_m [0.5 x'A_m x - b_m'x]."""

    A: torch.Tensor  # (M, d, d), symmetric, each >= mu I
    b: torch.Tensor  # (M, d)

    # Every tensor is client-major and zero pads are benign: shard="clients"
    # applies (problems.client_shard).
    client_shardable = True

    # --- structural properties -------------------------------------------------
    @property
    def num_clients(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.A.device

    @cached_property
    def A_bar(self) -> torch.Tensor:
        """Mean client Hessian, computed once (every `full_grad` reuses it)."""
        return self.A.mean(dim=0)

    @cached_property
    def b_bar(self) -> torch.Tensor:
        return self.b.mean(dim=0)

    # --- oracle access ---------------------------------------------------------
    def grad(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Gradient of f_m at x, batched over the shape of ``m``."""
        return _mv(self.A[m], x) - self.b[m]

    def full_grad(self, x: torch.Tensor) -> torch.Tensor:
        return _mv(self.A_bar, x) - self.b_bar

    def loss(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (x * _mv(self.A[m], x)).sum(-1) - (self.b[m] * x).sum(-1)

    def full_loss(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (x * _mv(self.A_bar, x)).sum(-1) - (self.b_bar * x).sum(-1)

    def hessian(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Constant client Hessian A_m (the Newton solvers' uniform oracle)."""
        del x
        return self.A[m]

    def local_oracle(self, m: torch.Tensor):
        """(grad_fn, hess_fn) of client(s) m with the (A_m, b_m) gather hoisted
        out of iterative prox solvers."""
        A_m = self.A[m]
        b_m = self.b[m]
        return (lambda x: _mv(A_m, x) - b_m), (lambda x: A_m)

    def prox(self, m: torch.Tensor, z: torch.Tensor, eta) -> torch.Tensor:
        """Exact prox_{eta f_m}(z) = (I + eta A_m)^{-1}(z + eta b_m).

        `solve_ex` leaves out `solve`'s singularity check, which waits on the
        device every call (I + eta A_m is positive definite; the reference's
        jnp solve checks nothing either)."""
        e = _per_lane(eta, z)
        H = torch.eye(self.dim, dtype=z.dtype, device=z.device) + e.unsqueeze(-1) * self.A[m]
        return torch.linalg.solve_ex(H, z + e * self.b[m])[0]

    def prox_factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-client eigendecompositions A_m = Q_m diag(lam_m) Q_m^T, once."""
        lam, Q = torch.linalg.eigh(self.A)
        return lam, Q

    def prox_spectral(self, m, z, eta, factors) -> torch.Tensor:
        """prox via the cached spectral factors: Q ((Q^T (z + eta b)) / (1 + eta lam))."""
        lam, Q = factors
        Q_m = Q[m]
        e = _per_lane(eta, z)
        rhs = z + e * self.b[m]
        return _mv(Q_m, _mv(Q_m.transpose(-1, -2), rhs) / (1.0 + e * lam[m]))

    def shifted(self, gamma: float, y: torch.Tensor) -> "QuadraticProblem":
        """Catalyst subproblem  h_t,m(x) = f_m(x) + gamma/2 ||x - y||^2."""
        eye = torch.eye(self.dim, dtype=self.A.dtype, device=self.A.device)
        return QuadraticProblem(A=self.A + gamma * eye, b=self.b + gamma * y)

    def shifted_lanes(self, gamma: torch.Tensor, y: torch.Tensor) -> "ShiftedQuadraticProblem":
        """The Catalyst subproblem of each lane: per-lane ``gamma`` ``S`` and
        centre ``y`` ``S + (d,)``, without copying the clients' data."""
        return ShiftedQuadraticProblem(self, gamma, y)

    # --- exact constants ---------------------------------------------------------
    def minimizer(self) -> torch.Tensor:
        return torch.linalg.solve(self.A_bar, self.b_bar)

    def smoothness(self) -> torch.Tensor:
        """L of the average objective f."""
        return torch.linalg.eigvalsh(self.A_bar)[-1]

    def smoothness_max(self) -> torch.Tensor:
        """max_m L_m — the per-client smoothness used by local solvers."""
        return torch.linalg.eigvalsh(self.A)[:, -1].max()

    def strong_convexity(self) -> torch.Tensor:
        """min over clients of the smallest eigenvalue (Assumption 2's mu)."""
        return torch.linalg.eigvalsh(self.A)[:, 0].min()

    def similarity(self) -> torch.Tensor:
        """Exact delta:  delta^2 = lambda_max((1/M) sum (A_m - Abar)^2)."""
        E = self.A - self.A_bar
        S = torch.matmul(E, E).mean(dim=0)
        return torch.sqrt(torch.linalg.eigvalsh(S)[-1])

    def similarity_max(self) -> torch.Tensor:
        """Per-client (Hessian-similarity) delta: max_m ||A_m - Abar||_op."""
        E = self.A - self.A_bar
        return torch.linalg.eigvalsh(E).abs().max()

    def grad_noise_at_opt(self) -> torch.Tensor:
        """sigma_*^2 = E_m ||grad f_m(x_*)||^2 (Theorem 1's noise constant)."""
        g = _mv(self.A, self.minimizer()) - self.b
        return (g * g).sum(-1).mean()


@dataclasses.dataclass(frozen=True, eq=False)
class ShiftedQuadraticProblem:
    """Catalyst's subproblem over lanes: lane s minimises

        h_m(x) = f_m(x) + gamma_s/2 ||x - y_s||^2,

    i.e. the quadratic (A_m + gamma_s I, b_m + gamma_s y_s).  Oracles take
    ``m`` of the lane shape ``S`` and rows ``S + (d,)``; each forms the
    shifted (A_m, b_m) of the clients it reads as `QuadraticProblem.shifted`
    forms all of them, so per lane it rounds as the reference's shifted
    problem does (the mean Hessian of `full_grad` is A_bar + gamma I).  The
    spectral prox takes the base problem's factors and shifts the
    eigenvalues by gamma_s."""

    base: QuadraticProblem
    gamma: torch.Tensor  # S
    anchor: torch.Tensor  # S + (d,)

    @property
    def num_clients(self) -> int:
        return self.base.num_clients

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def device(self) -> torch.device:
        return self.base.device

    def _gamma(self, trailing: int) -> torch.Tensor:
        return self.gamma.reshape(self.gamma.shape + (1,) * trailing)

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.dim, dtype=self.base.A.dtype, device=self.base.A.device)

    def _A(self, m) -> torch.Tensor:
        return self.base.A[m] + self._gamma(2) * self._eye()

    def _b(self, m) -> torch.Tensor:
        return self.base.b[m] + self._gamma(1) * self.anchor

    def grad(self, m, x):
        return _mv(self._A(m), x) - self._b(m)

    def full_grad(self, x):
        return (_mv(self.base.A_bar + self._gamma(2) * self._eye(), x)
                - (self.base.b_bar + self._gamma(1) * self.anchor))

    def hessian(self, m, x):
        del x
        return self._A(m)

    def local_oracle(self, m):
        A_m, b_m = self._A(m), self._b(m)
        return (lambda x: _mv(A_m, x) - b_m), (lambda x: A_m)

    def prox(self, m, z, eta):
        e = _per_lane(eta, z)
        H = self._eye() + e.unsqueeze(-1) * self._A(m)
        return torch.linalg.solve_ex(H, z + e * self._b(m))[0]

    def prox_factors(self):
        """The base problem's eigendecompositions (`prox_spectral` shifts them)."""
        return self.base.prox_factors()

    def prox_spectral(self, m, z, eta, factors):
        lam, Q = factors
        Q_m = Q[m]
        e = _per_lane(eta, z)
        rhs = z + e * self._b(m)
        return _mv(Q_m, _mv(Q_m.transpose(-1, -2), rhs) / (1.0 + e * (lam[m] + self._gamma(1))))


@dataclasses.dataclass(frozen=True, eq=False)
class PooledQuadraticProblem(QuadraticProblem):
    """P tenants' quadratics of one shape as one problem over lane groups.

    The clients are the tenants' clients stacked in order (tenant i's client
    m is client ``i M + m``), so every client-indexed oracle (``grad``, the
    exact and spectral prox, ``local_oracle``) is the tenant's own, while
    ``num_clients`` is a tenant's M (the rounds' comm accounting reads it).
    The lanes come in P groups of ``B``, one a tenant, and ``full_grad``
    gives each group its tenant's mean Hessian (``A_bars`` / ``b_bars``,
    the tenants' own `A_bar` and `b_bar`)."""

    A_bars: torch.Tensor = None  # (P, d, d)
    b_bars: torch.Tensor = None  # (P, d)

    @property
    def num_clients(self) -> int:
        return self.A.shape[0] // self.A_bars.shape[0]

    def full_grad(self, x: torch.Tensor) -> torch.Tensor:
        P = self.A_bars.shape[0]
        xs = x.reshape(P, -1, x.shape[-1])
        return (_mv(self.A_bars.unsqueeze(1), xs) - self.b_bars.unsqueeze(1)).reshape(x.shape)


def stack_quadratics(problems) -> PooledQuadraticProblem:
    """`PooledQuadraticProblem` of same-shaped quadratics, tenant order kept."""
    return PooledQuadraticProblem(
        A=torch.cat([q.A for q in problems]), b=torch.cat([q.b for q in problems]),
        A_bars=torch.stack([q.A_bar for q in problems]),
        b_bars=torch.stack([q.b_bar for q in problems]),
    )


def _random_orthogonal(rng: np.random.Generator, d: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((d, d)))
    return q * np.sign(np.diag(r))


def make_synthetic_quadratic(
    num_clients: int,
    dim: int,
    mu: float = 1.0,
    L: float = 3330.0,
    delta: float = 10.0,
    noise: float = 1.0,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device | None = None,
) -> QuadraticProblem:
    """Synthetic family matching the paper's setup: delta << L forced by design.

    A shared base Hessian with spectrum spanning [mu+delta, L], plus zero-sum
    client perturbations rescaled so that lambda_max((1/M) sum E_m^2) = delta^2.
    """
    rng = np.random.default_rng(seed)
    lo, hi = mu + delta, max(L - delta, mu + 2 * delta)
    eigs = np.exp(rng.uniform(np.log(lo), np.log(hi), size=dim))
    eigs[0], eigs[-1] = lo, hi
    Q = _random_orthogonal(rng, dim)
    A_base = (Q * eigs) @ Q.T

    E = rng.standard_normal((num_clients, dim, dim))
    E = 0.5 * (E + np.swapaxes(E, 1, 2))
    E -= E.mean(axis=0, keepdims=True)
    S = np.mean(np.einsum("mij,mjk->mik", E, E), axis=0)
    cur = np.sqrt(np.linalg.eigvalsh(S)[-1])
    E *= delta / cur

    A = A_base[None] + E
    min_eig = min(np.linalg.eigvalsh(A_m)[0] for A_m in A)
    if min_eig < mu:
        A += (mu - min_eig) * np.eye(dim)[None]

    b = noise * rng.standard_normal((num_clients, dim))
    dev = resolve_device(device)
    return QuadraticProblem(
        A=torch.as_tensor(A, dtype=dtype, device=dev),
        b=torch.as_tensor(b, dtype=dtype, device=dev),
    )


def make_ridge_problem(
    Z: np.ndarray,  # (M, n, d) per-client features
    y: np.ndarray,  # (M, n) per-client labels
    lam: float,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device | None = None,
) -> QuadraticProblem:
    """Ridge regression per the paper:  f_m(x) = (1/n)||Z_m x - y_m||^2 + lam/2 ||x||^2,
    so A_m = (2/n) Z_m^T Z_m + lam I  and  b_m = (2/n) Z_m^T y_m."""
    M, n, d = Z.shape
    A = 2.0 / n * np.einsum("mni,mnj->mij", Z, Z) + lam * np.eye(d)[None]
    b = 2.0 / n * np.einsum("mni,mn->mi", Z, y)
    dev = resolve_device(device)
    return QuadraticProblem(
        A=torch.as_tensor(A, dtype=dtype, device=dev),
        b=torch.as_tensor(b, dtype=dtype, device=dev),
    )
