"""K1's loop form (`repro_torch.kernels.prox_update.quadratic_prox_gd_batched`) on the CPU.

On the CPU the wrapper runs its plain version: the quadratic gradient
``A[m] y - b[m]`` of `QuadraticProblem.local_oracle`, then K1's plain update,
``num_steps`` times.  These tests hold it

* against the reference's fused quadratic solve (`repro.core.rounds.prox_gd_fused`,
  and `repro.core.prox.prox_gd_batched` for a given start ``y0`` or scalar
  ``eta`` / ``L``), which runs the Pallas K1 in interpret mode, on a `repro`
  quadratic problem built from the same float64 numpy arrays, at rtol 1e-12
  (atol 1e-13 for elements near zero): both run the same steps, and only the
  matvec's summation order differs between XLA and PyTorch;
* bit for bit against the loop the port's quadratic sweeps ran before, one
  `prox_update_batched` a step (`core.prox.prox_gd_batched(..., use_kernel=True)`);
* and check that the port's `core.rounds.prox_gd_fused` sends quadratic
  problems through it and logistic problems through K2.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import prox as rprox  # noqa: E402
from repro.core import rounds as rrounds  # noqa: E402
from repro.problems.quadratic import QuadraticProblem as RQuadratic  # noqa: E402
from repro_torch.core import prox as tprox  # noqa: E402
from repro_torch.core import rounds as trounds  # noqa: E402
from repro_torch.kernels import logistic_prox as tlogistic  # noqa: E402
from repro_torch.kernels import prox_update as tk1  # noqa: E402
from repro_torch.problems import make_a9a_like_problem  # noqa: E402
from repro_torch.problems.quadratic import QuadraticProblem  # noqa: E402

REF_TOL = dict(rtol=1e-12, atol=1e-13)
M, D, STEPS = 10, 6, 40


def _spd_clients(rng, M, d, dtype=np.float64):
    """M symmetric positive definite (d, d) matrices with spectra in [1, 50]."""
    A = np.empty((M, d, d))
    for i in range(M):
        q, _ = np.linalg.qr(rng.standard_normal((d, d)))
        A[i] = (q * np.exp(rng.uniform(0.0, np.log(50.0), d))) @ q.T
    return (0.5 * (A + A.transpose(0, 2, 1))).astype(dtype)


def _inputs(rows: str, seed: int, dtype=np.float64):
    """A (M, d, d), b (M, d), the row clients m (R,), z and y0 (R, d), per-row
    eta and L (R,).  ``rows``: "single" (one client a trial, R = 5 trials) or
    "cohort" (3 trials x 4 cohort clients drawn without replacement, R = 12)."""
    rng = np.random.default_rng(seed)
    A = _spd_clients(rng, M, D, dtype)
    b = rng.standard_normal((M, D)).astype(dtype)
    if rows == "single":
        m = rng.integers(0, M, size=5)
        eta_t = rng.uniform(0.05, 0.5, size=5)
        eta = eta_t
    else:
        m = np.concatenate([rng.permutation(M)[:4] for _ in range(3)])
        eta_t = rng.uniform(0.05, 0.5, size=3)
        eta = np.repeat(eta_t, 4)  # the cohort rows of a trial share its eta
    R = m.shape[0]
    z = rng.standard_normal((R, D)).astype(dtype)
    y0 = rng.standard_normal((R, D)).astype(dtype)
    L = np.full(R, 50.0)
    return A, b, m.astype(np.int64), z, y0, eta.astype(dtype), L.astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_loop(A, b, m, z, eta, L, y0=None):
    zt = _t(z)
    beta, inv_eta = tprox.gd_row_scalars(zt, _t(eta) if np.ndim(eta) else float(eta),
                                         _t(L) if np.ndim(L) else float(L))
    return tk1.quadratic_prox_gd_batched(_t(A), _t(b), _t(m), zt, beta, inv_eta, STEPS,
                                         y0=None if y0 is None else _t(y0))


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    tk1.quadratic_prox_gd_batched.launches = 0
    tk1.prox_update_batched.launches = 0
    yield


@pytest.mark.parametrize("scalars", ["per_row", "scalar"])
@pytest.mark.parametrize("start", ["z", "y0"])
@pytest.mark.parametrize("rows", ["single", "cohort"])
def test_plain_loop_matches_reference_fused_solve(rows, start, scalars):
    A, b, m, z, y0, eta, L = _inputs(rows, seed=11)
    if scalars == "scalar":
        eta, L = eta[0], L[0]
    y_start = y0 if start == "y0" else None
    got = _port_loop(A, b, m, z, eta, L, y_start).numpy()

    problem = RQuadratic(A=jnp.asarray(A), b=jnp.asarray(b))
    mj, zj = jnp.asarray(m), jnp.asarray(z)
    if start == "z" and scalars == "per_row":
        # The reference's fused round solve itself: K1 in interpret mode.
        want = rrounds.prox_gd_fused(problem, mj, zj, jnp.asarray(eta), jnp.asarray(L), STEPS,
                                     interpret=True)
    else:  # what prox_gd_fused calls, with the start or the scalars it does not take
        grad_b = jax.vmap(problem.grad)
        want = rprox.prox_gd_batched(lambda y: grad_b(mj, y), zj, jnp.asarray(eta),
                                     jnp.asarray(L), STEPS,
                                     y0=None if y_start is None else jnp.asarray(y_start),
                                     use_kernel=True, interpret=True)
    want = np.asarray(want)
    assert got.shape == z.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, **REF_TOL)
    assert np.abs(got - z).max() > 1e-3  # the solve moved: the comparison is not vacuous
    assert tk1.quadratic_prox_gd_batched.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("start", ["z", "y0"])
@pytest.mark.parametrize("rows", ["single", "cohort"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_loop_equals_the_elementwise_loop_bit_for_bit(dtype, rows, start):
    """The CPU results of the quadratic sweeps are what they were before."""
    A, b, m, z, y0, eta, L = _inputs(rows, seed=12, dtype=dtype)
    y_start = _t(y0) if start == "y0" else None
    got = _port_loop(A, b, m, z, eta, L, y0=None if y_start is None else y0)
    grad_fn, _ = QuadraticProblem(A=_t(A), b=_t(b)).local_oracle(_t(m))
    before = tprox.prox_gd_batched(grad_fn, _t(z), _t(eta), _t(L), STEPS, y0=y_start,
                                   use_kernel=True)
    assert got.dtype == before.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert torch.equal(got, before)


def test_fused_solve_sends_quadratics_through_the_loop_kernel(monkeypatch):
    A, b, m, z, _, eta, L = _inputs("cohort", seed=13)
    calls = []
    real = tk1.quadratic_prox_gd_batched

    def spy(*args, **kwargs):
        calls.append(args[6])
        return real(*args, **kwargs)

    def forbidden(*args, **kwargs):
        raise AssertionError("a quadratic solve took the per-step kernel")

    monkeypatch.setattr(tk1, "quadratic_prox_gd_batched", spy)
    monkeypatch.setattr(tk1, "prox_update_batched", forbidden)
    problem = QuadraticProblem(A=_t(A), b=_t(b))
    got = trounds.prox_gd_fused(problem, _t(m), _t(z), _t(eta), _t(L), STEPS)
    assert calls == [STEPS]
    torch.testing.assert_close(got, _port_loop(A, b, m, z, eta, L), rtol=0, atol=0)


def test_fused_solve_sends_logistic_problems_through_k2(monkeypatch):
    problem = make_a9a_like_problem(6, 40, n_pool=300, dim=12, nnz_per_row=4, seed=1,
                                    device="cpu")
    calls = []
    real = tlogistic.logistic_prox_gd_indexed

    def spy(*args, **kwargs):
        calls.append((args[0] is problem.Z, args[1] is problem.y, args[2].tolist(),
                      kwargs["check_indices"]))
        return real(*args, **kwargs)

    def forbidden(*args, **kwargs):
        raise AssertionError("a logistic solve took the quadratic loop kernel")

    monkeypatch.setattr(tlogistic, "logistic_prox_gd_indexed", spy)
    monkeypatch.setattr(tk1, "quadratic_prox_gd_batched", forbidden)
    m = torch.tensor([0, 3, 5])
    z = torch.zeros((3, problem.dim), dtype=torch.float64)
    eta = torch.full((3,), 0.5, dtype=torch.float64)
    L = torch.full((3,), 2.0, dtype=torch.float64)
    out = trounds.prox_gd_fused(problem, m, z, eta, L, 5)
    # The clients' features and labels in place (no gather before the call),
    # the sweep's draws already range-checked.
    assert calls == [(True, True, [0, 3, 5], False)] and out.shape == z.shape
    A = problem.Z[m] * problem.y[m][:, :, None]
    want = tlogistic.logistic_prox_gd_batched_plain(A, z, 1.0 / (L + 1.0 / eta), 1.0 / eta,
                                                    problem.lam, 5)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_sweep_refuses_draws_outside_its_clients():
    """The fused quadratic solve reads client data unchecked: the sweep
    checks its draws' range once, when it starts."""
    from repro_torch.core import Draws, draw_schedule
    from repro_torch.experiments import run_batch
    from repro_torch.problems import make_synthetic_quadratic

    problem = make_synthetic_quadratic(10, 6, L=80.0, delta=4.0, seed=1, device="cpu")
    draws = draw_schedule([0, 0, 1, 1], 10, 5, 0.2)
    kw = dict(grid={"eta": [0.1, 0.05], "p": 0.2, "smoothness": 80.0}, seeds=2, fused=True,
              num_steps=5, prox_solver="gd", prox_steps=3, device="cpu")
    assert run_batch("svrp", problem, draws=draws, **kw).dist_sq.shape == (4, 5)
    for wrong in (draws.clients + 10, draws.clients - 10):
        with pytest.raises(ValueError, match="outside"):
            run_batch("svrp", problem, draws=Draws(wrong, draws.coins), **kw)
