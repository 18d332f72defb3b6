"""The port's prox-solver registry (`repro_torch.core.prox`) against `repro.core.prox`.

Every registered solver is run through its registry entry
(``prepare`` then ``solve``) in both packages on the same client and target,
float64: the fixed-step solvers (gd, agd) to rtol 1e-12, the solvers that
factorize or stop on a tolerance (exact, spectral, newton, newton-cg) to
rtol 1e-9.  Batched lanes are held against the reference's vmapped solve,
which is what the lane-by-lane early exit must reproduce.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import prox as rprox  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import prox as tprox  # noqa: E402

FIXED = dict(rtol=1e-12, atol=1e-13)
SOLVED = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module")
def problems():
    q = make_synthetic_quadratic(num_clients=10, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1)
    lg = make_a9a_like_problem(num_clients=5, n_per_client=40, n_pool=300, dim=12,
                               nnz_per_row=4, seed=1)
    return {
        "quadratic": (q, problem_from_arrays(
            "quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)}, device="cpu")),
        "logistic": (lg, problem_from_arrays(
            "logistic", {"Z": np.asarray(lg.Z), "y": np.asarray(lg.y), "lam": lg.lam},
            device="cpu")),
    }


SOLVER_CASES = [
    (name, kind)
    for name in sorted(tprox.PROX_SOLVERS)
    for kind in ("quadratic", "logistic")
    if not (tprox.PROX_SOLVERS[name].quadratic_only and kind == "logistic")
]


@pytest.mark.parametrize("name,kind", SOLVER_CASES)
def test_registered_solver_matches_reference(problems, name, kind):
    ref_p, port_p = problems[kind]
    d = ref_p.dim
    z = np.random.default_rng(0).standard_normal(d)
    m, eta = 3, 0.4
    L = float(ref_p.smoothness_max())
    kw = dict(smoothness=L, steps=30, tol=1e-10)
    rs, ts = rprox.get_prox_solver(name, ref_p), tprox.get_prox_solver(name, port_p)
    assert (rs.name, rs.requires, rs.quadratic_only) == (ts.name, ts.requires, ts.quadratic_only)
    want = rs.solve(ref_p, rs.prepare(ref_p), m, jnp.asarray(z), eta, **kw)
    got = ts.solve(port_p, ts.prepare(port_p), torch.tensor(m), torch.as_tensor(z), eta, **kw)
    tol = FIXED if name == "gd" else SOLVED
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_registry_names_match():
    assert sorted(tprox.PROX_SOLVERS) == sorted(rprox.PROX_SOLVERS)


@pytest.mark.parametrize("solver", ["newton", "newton-cg"])
def test_batched_lanes_match_vmapped_reference(problems, solver):
    """Lanes with different targets/stepsizes converge after different
    iteration counts; each must follow its own trajectory."""
    ref_p, port_p = problems["logistic"]
    rng = np.random.default_rng(1)
    z = rng.standard_normal((4, ref_p.dim)) * np.array([[0.1], [1.0], [3.0], [6.0]])
    eta = np.array([0.3, 1.0, 10.0, 100.0])
    m = np.array([0, 1, 2, 4])
    rs = rprox.get_prox_solver(solver, ref_p)

    def one(mm, zz, ee):
        return rs.solve(ref_p, None, mm, zz, ee, smoothness=0.0, steps=40, tol=1e-10)

    want = jax.vmap(one)(jnp.asarray(m), jnp.asarray(z), jnp.asarray(eta))
    ts = tprox.get_prox_solver(solver, port_p)
    got = ts.solve(port_p, None, torch.as_tensor(m), torch.as_tensor(z), torch.as_tensor(eta),
                   smoothness=0.0, steps=40, tol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVED)


def test_prox_gd_and_agd_match(problems):
    ref_p, port_p = problems["quadratic"]
    z = np.random.default_rng(2).standard_normal(ref_p.dim)
    g_r, _ = ref_p.local_oracle(4)
    g_t, _ = port_p.local_oracle(torch.tensor(4))
    L = float(ref_p.smoothness_max())
    np.testing.assert_allclose(
        tprox.prox_gd(g_t, torch.as_tensor(z), 0.2, L, 25).numpy(),
        np.asarray(rprox.prox_gd(g_r, jnp.asarray(z), 0.2, L, 25)), **FIXED)
    np.testing.assert_allclose(
        tprox.prox_agd(g_t, torch.as_tensor(z), 0.2, L, 1.0, 25).numpy(),
        np.asarray(rprox.prox_agd(g_r, jnp.asarray(z), 0.2, L, 1.0, 25)), **FIXED)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["torch_expr", "kernel_seam"])
def test_prox_gd_batched_matches(problems, use_kernel):
    """`prox_gd_batched` per-trial eta/L, both sides of its kernel seam (the
    kernel wrapper takes its plain version for CPU tensors)."""
    ref_p, port_p = problems["quadratic"]
    rng = np.random.default_rng(3)
    ms = np.array([0, 2, 4, 5])
    z = rng.standard_normal((4, ref_p.dim))
    eta = np.array([0.5, 0.2, 1.0, 0.1])
    L = np.full(4, float(ref_p.smoothness_max()))
    grad_b = jax.vmap(ref_p.grad)
    want = rprox.prox_gd_batched(lambda y: grad_b(jnp.asarray(ms), y), jnp.asarray(z),
                                 jnp.asarray(eta), jnp.asarray(L), 30, use_kernel=use_kernel)
    g_t, _ = port_p.local_oracle(torch.as_tensor(ms))
    got = tprox.prox_gd_batched(g_t, torch.as_tensor(z), torch.as_tensor(eta),
                                torch.as_tensor(L), 30, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FIXED)


class _Bare:
    """A problem object offering no oracle at all."""

    num_clients = 1


@pytest.mark.parametrize("name,kind", [
    ("no-such-solver", "quadratic"),
    ("spectral", "logistic"),
    ("gd", "bare"),
    ("newton", "bare"),
    ("exact", "bare"),
])
def test_get_prox_solver_error_texts_match(problems, name, kind):
    ref_p, port_p = (_Bare(), _Bare()) if kind == "bare" else problems[kind]
    with pytest.raises(ValueError) as r:
        rprox.get_prox_solver(name, ref_p)
    with pytest.raises(ValueError) as t:
        tprox.get_prox_solver(name, port_p)
    assert str(t.value) == str(r.value)


def test_gd_steps_for_accuracy_matches():
    for args in [(0.1, 80.0, 1.0, 1e-8, 1.0), (1.0, 5.0, 0.5, 1e-3, 1e-4), (0.01, 3330.0, 1.0, 1e-12, 2.0)]:
        assert tprox.gd_steps_for_accuracy(*args) == rprox.gd_steps_for_accuracy(*args)
