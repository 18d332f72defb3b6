"""Differentially private ERM: the paper's headline application of
second-order similarity.  Port of `repro.problems.dp_erm`.

Mechanism: each client releases the OBJECTIVE-PERTURBED loss

    f_m^DP(x) = f_m(x) + s_m^T x,      s_m = nu * xi_m,   xi_m ~ N(0, I_d),

with nu = sigma * 2 clip / n, the Gaussian mechanism's scale at the
replace-one sensitivity 2 clip / n of a client whose per-sample rows are
clipped to norm <= clip.  The noise table ``dp_shift`` (M, d) is drawn once
when the problem is built (here from a `torch.Generator`; `convert` takes the
reference's table as numpy, so both packages solve the same problem) and is
problem data, so every substrate sees the same noise.

The perturbation is linear in x, so the Hessians, and with them the
similarity constant delta, are the base problem's; prox_{eta f^DP}(z) =
prox_{eta f}(z - eta s_m), which the fused logistic path folds into K2's
target with the unshifted start (`core.rounds.prox_gd_fused`); a quadratic
carries the shift in ``b`` and needs nothing else.

Accounting: `privacy_spent(steps, p, sigma)` is the zCDP composition of
``steps`` Gaussian releases at noise multiplier sigma, each touching a
client with probability p: rho = steps p / (2 sigma^2), eps = rho + 2
sqrt(rho ln(1/delta)).  It prices a schedule that draws fresh noise at every
release; the simulation reuses each client's one draw (see the reference's
module docstring), so it is the budget of that schedule, not a certificate
for the replayed run.  `similarity_bound` is the clip-composed
O(1/sqrt(n)) estimate of delta by matrix concentration.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.problems.logistic import LogisticProblem, make_a9a_like_problem
from repro_torch.problems.quadratic import QuadraticProblem


# ------------------------------------------------------------- zCDP accountant
def zcdp_to_eps(rho: float, target_delta: float) -> float:
    """rho-zCDP implies (rho + 2 sqrt(rho ln(1/delta)), delta)-DP (Bun & Steinke)."""
    if rho == math.inf:
        return math.inf
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / target_delta))


def privacy_spent(steps: int, p: float, sigma: float, *,
                  target_delta: float = 1e-5) -> tuple[float, float]:
    """(eps, delta_dp) after ``steps`` rounds at client-sampling rate p and
    noise multiplier sigma, by linear zCDP composition (no subsampling
    amplification): rho = steps p / (2 sigma^2)."""
    if steps < 0 or not (0.0 <= p <= 1.0):
        raise ValueError(f"need steps >= 0 and 0 <= p <= 1, got {steps=}, {p=}")
    if sigma < 0:
        raise ValueError(f"noise multiplier must be >= 0, got {sigma=}")
    rho = math.inf if sigma == 0.0 else steps * p / (2.0 * sigma**2)
    return zcdp_to_eps(rho, target_delta), target_delta


def _hessian_concentration_bound(hess_bound: float, n: int, d: int) -> float:
    """delta <= 2 B_H sqrt(8 log(2d) / n): a mean of n i.i.d. per-sample
    Hessians (op-norm <= B_H) around its population mean, doubled for a
    client's deviation from the pool average."""
    return 2.0 * hess_bound * math.sqrt(8.0 * math.log(2.0 * d) / n)


# ------------------------------------------------------------------ quadratic
@dataclasses.dataclass(frozen=True, eq=False)
class DPQuadraticProblem(QuadraticProblem):
    """A QuadraticProblem whose ``b`` already carries the perturbation
    (b = b_base - s), plus the DP metadata.  Every oracle and constant is
    the quadratic's."""

    dp_shift: torch.Tensor = None  # (M, d) s_m, already folded into b
    dp_sigma: float = 1.0
    dp_clip: float = 1.0
    dp_n: int = 1

    def base_problem(self) -> QuadraticProblem:
        """The non-private comparator: the same A, the unnoised b."""
        return QuadraticProblem(A=self.A, b=self.b + self.dp_shift)

    def dp_linear_term(self, m: torch.Tensor) -> torch.Tensor:
        """s_m rows (the quadratic's fused path reads the noise through b)."""
        return self.dp_shift[m]

    def privacy_spent(self, steps: int, p: float, *,
                      target_delta: float = 1e-5) -> tuple[float, float]:
        return privacy_spent(steps, p, self.dp_sigma, target_delta=target_delta)

    def similarity_bound(self) -> float:
        """Ridge convention: the per-sample Hessian 2 z z' has op-norm <= 2 clip^2."""
        return _hessian_concentration_bound(2.0 * self.dp_clip**2, self.dp_n, self.dim)


def make_dp_quadratic(base: QuadraticProblem, generator: torch.Generator | None = None, *,
                      sigma: float, clip: float, n_per_client: int) -> DPQuadraticProblem:
    """Wrap a quadratic with the per-client perturbation at nu = sigma 2 clip / n:
    grad f_m^DP = A_m x - b_m + s_m, i.e. b <- b - s.  The noise xi is drawn
    from ``generator`` (default: a CPU generator seeded 0)."""
    nu = sigma * 2.0 * clip / n_per_client
    dp_shift = nu * _normal(generator, base.b.shape, base.b.dtype, base.b.device)
    return DPQuadraticProblem(A=base.A, b=base.b - dp_shift, dp_shift=dp_shift,
                              dp_sigma=sigma, dp_clip=clip, dp_n=n_per_client)


# ------------------------------------------------------------------- logistic
@dataclasses.dataclass(frozen=True, eq=False)
class DPLogisticProblem(LogisticProblem):
    """LogisticProblem with feature rows clipped to norm <= dp_clip and the
    per-client linear perturbation s_m added to every gradient oracle.  The
    Hessians are untouched; `prox` and `minimizer` run the guarded Newton on
    the noised `local_oracle` / `full_grad`."""

    dp_shift: torch.Tensor = None  # (M, d) s_m
    dp_sigma: float = 1.0
    dp_clip: float = 1.0

    @property
    def dp_n(self) -> int:
        return self.Z.shape[1]

    def base_problem(self) -> LogisticProblem:
        """The non-private comparator: the same clipped data, no noise."""
        return LogisticProblem(Z=self.Z, y=self.y, lam=self.lam)

    def dp_linear_term(self, m: torch.Tensor) -> torch.Tensor:
        return self.dp_shift[m]

    # --- noised oracles (the linear term has zero Hessian) ------------------
    def loss(self, m, x):
        return super().loss(m, x) + (self.dp_shift[m] * x).sum(-1)

    def full_loss(self, x):
        return super().full_loss(x) + (self.dp_shift.mean(dim=0) * x).sum(-1)

    def grad(self, m, x):
        return super().grad(m, x) + self.dp_shift[m]

    def full_grad(self, x):
        return super().full_grad(x) + self.dp_shift.mean(dim=0)

    def local_oracle(self, m):
        grad0, hess0 = super().local_oracle(m)
        s_m = self.dp_shift[m]
        return (lambda x: grad0(x) + s_m), hess0

    # --- DP metadata ---------------------------------------------------------
    def privacy_spent(self, steps: int, p: float, *,
                      target_delta: float = 1e-5) -> tuple[float, float]:
        return privacy_spent(steps, p, self.dp_sigma, target_delta=target_delta)

    def similarity_bound(self) -> float:
        """Logistic per-sample Hessians sigma'(t) z z' have op-norm <= clip^2 / 4."""
        return _hessian_concentration_bound(self.dp_clip**2 / 4.0, self.dp_n, self.dim)


def clip_rows(Z: torch.Tensor, clip: float) -> torch.Tensor:
    """Rows with ||z_i|| > clip rescaled onto the clip sphere (the others
    unchanged)."""
    norms = torch.linalg.vector_norm(Z, dim=-1, keepdim=True)
    scale = torch.clamp(clip / torch.clamp(norms, min=1e-30), max=1.0)
    return Z * scale


def make_dp_logistic(base: LogisticProblem, generator: torch.Generator | None = None, *,
                     sigma: float, clip: float) -> DPLogisticProblem:
    """Clip the base problem's feature rows to norm <= clip and add the
    per-client Gaussian perturbation at nu = sigma 2 clip / n, drawn from
    ``generator`` (default: a CPU generator seeded 0)."""
    nu = sigma * 2.0 * clip / base.Z.shape[1]
    dp_shift = nu * _normal(generator, (base.num_clients, base.dim), base.Z.dtype, base.Z.device)
    return DPLogisticProblem(Z=clip_rows(base.Z, clip), y=base.y, lam=base.lam,
                             dp_shift=dp_shift, dp_sigma=sigma, dp_clip=clip)


def make_dp_a9a_problem(num_clients: int, *, sigma: float = 1.0, clip: float = 1.0,
                        n_per_client: int = 2000, lam: float = 0.1, n_pool: int = 32561,
                        dim: int = 123, seed: int = 0, noise_seed: int = 1,
                        dtype: torch.dtype = torch.float64, device=None,
                        **kwargs) -> DPLogisticProblem:
    """The DP-ERM validation instance: the a9a-statistics-matched logistic
    pool (bit-identical to the reference's for one ``seed``) privatized by
    row clipping and objective perturbation, the noise drawn from a CPU
    `torch.Generator` seeded with ``noise_seed`` (the same problem on any
    device), on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    base = make_a9a_like_problem(num_clients, n_per_client=n_per_client, lam=lam, n_pool=n_pool,
                                 dim=dim, seed=seed, dtype=dtype, device=dev, **kwargs)
    return make_dp_logistic(base, torch.Generator().manual_seed(noise_seed), sigma=sigma,
                            clip=clip)


def _normal(generator: torch.Generator | None, shape, dtype, device) -> torch.Tensor:
    """Standard normal noise from ``generator`` (default: a CPU generator
    seeded 0), drawn on the generator's device and moved to ``device``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device).to(device)
