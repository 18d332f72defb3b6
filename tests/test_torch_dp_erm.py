"""The port's DP-ERM problems against `repro`, on the CPU in float64.

The zCDP accountant; the DP quadratic and logistic problems built from the
reference's own noise table (`convert.problem_from_arrays` with its
``dp_shift``), their noised oracles, minimizers and clip-composed
similarity bounds; row clipping; the native builders; and svrp on the DP
logistic problem through the fused path (the noise folded into K2's target,
from the unshifted start y0 = z; K2's plain version here) and the registry
path, each against the reference's run with its draws replayed: comm equal,
dist_sq rtol 1e-9.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import draws_from_numpy, replay_draws  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.problems import dp_erm as rdp  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.experiments import run_batch  # noqa: E402
from repro_torch.kernels import logistic_prox as k2  # noqa: E402
from repro_torch.problems import dp_erm as tdp  # noqa: E402

RTOL = 1e-9
M = 6


@pytest.fixture(scope="module")
def quads():
    base = make_synthetic_quadratic(num_clients=8, dim=6, mu=1.0, L=50.0, delta=3.0, seed=0)
    ref = rdp.make_dp_quadratic(base, jax.random.key(7), sigma=2.0, clip=1.0, n_per_client=100)
    arrays = {"A": ref.A, "b": ref.b, "dp_shift": ref.dp_shift, "dp_sigma": 2.0,
              "dp_clip": 1.0, "dp_n": 100}
    return ref, problem_from_arrays("quadratic", arrays, device="cpu")


@pytest.fixture(scope="module")
def logistics():
    base = make_a9a_like_problem(num_clients=M, n_per_client=30, n_pool=300, dim=16, seed=2)
    ref = rdp.make_dp_logistic(base, jax.random.key(12), sigma=2.0, clip=1.0)
    arrays = {"Z": ref.Z, "y": ref.y, "lam": ref.lam, "dp_shift": ref.dp_shift,
              "dp_sigma": 2.0, "dp_clip": 1.0}
    return base, ref, problem_from_arrays("logistic", arrays, device="cpu")


@pytest.mark.parametrize("steps,p,sigma", [(100, 0.1, 1.0), (400, 0.25, 4.0), (0, 1.0, 2.0),
                                           (10, 0.5, 0.0)])
def test_accountant_matches_the_reference(steps, p, sigma):
    assert tdp.privacy_spent(steps, p, sigma) == rdp.privacy_spent(steps, p, sigma)
    assert tdp.zcdp_to_eps(0.3, 1e-6) == rdp.zcdp_to_eps(0.3, 1e-6)
    assert tdp.zcdp_to_eps(math.inf, 1e-6) == math.inf


@pytest.mark.parametrize("bad", [dict(steps=-1, p=0.1, sigma=1.0), dict(steps=1, p=1.5, sigma=1.0),
                                 dict(steps=1, p=0.1, sigma=-1.0)])
def test_accountant_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as r:
        rdp.privacy_spent(bad["steps"], bad["p"], bad["sigma"])
    with pytest.raises(ValueError) as t:
        tdp.privacy_spent(bad["steps"], bad["p"], bad["sigma"])
    assert str(t.value) == str(r.value)


def test_dp_quadratic_oracles_and_constants(quads):
    ref, got = quads
    rng = np.random.default_rng(0)
    x = rng.standard_normal(6)
    for m in range(8):
        np.testing.assert_allclose(got.grad(torch.tensor(m), torch.from_numpy(x)).numpy(),
                                   np.asarray(ref.grad(jnp.asarray(m), jnp.asarray(x))),
                                   rtol=1e-12)
    np.testing.assert_allclose(got.minimizer().numpy(), np.asarray(ref.minimizer()), rtol=1e-10)
    np.testing.assert_allclose(got.base_problem().minimizer().numpy(),
                               np.asarray(ref.base_problem().minimizer()), rtol=1e-10)
    np.testing.assert_allclose(float(got.similarity()), float(ref.similarity()), rtol=1e-12)
    np.testing.assert_allclose(float(got.similarity()), float(got.base_problem().similarity()),
                               rtol=1e-14)  # a linear perturbation leaves delta alone
    assert got.similarity_bound() == pytest.approx(ref.similarity_bound(), rel=1e-15)
    assert got.privacy_spent(50, 0.2) == ref.privacy_spent(50, 0.2)
    np.testing.assert_array_equal(got.dp_linear_term(torch.tensor([1, 3])).numpy(),
                                  np.asarray(ref.dp_linear_term(jnp.asarray([1, 3]))))


def test_dp_logistic_oracles_and_constants(logistics):
    _, ref, got = logistics
    rng = np.random.default_rng(1)
    x = 0.3 * rng.standard_normal(16)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ms = np.array([0, 2, 5])
    X = 0.3 * rng.standard_normal((3, 16))
    for name in ("loss", "grad"):
        want = np.asarray(jax.vmap(getattr(ref, name))(jnp.asarray(ms), jnp.asarray(X)))
        np.testing.assert_allclose(getattr(got, name)(torch.from_numpy(ms), torch.from_numpy(X))
                                   .numpy(), want, rtol=1e-12, atol=1e-15)
    for name in ("full_loss", "full_grad"):
        np.testing.assert_allclose(getattr(got, name)(xt).numpy(),
                                   np.asarray(getattr(ref, name)(xj)), rtol=1e-12, atol=1e-15)
    tg, _ = got.local_oracle(torch.tensor(4))
    rg, _ = ref.local_oracle(jnp.asarray(4))
    np.testing.assert_allclose(tg(xt).numpy(), np.asarray(rg(xj)), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.minimizer().numpy(), np.asarray(ref.minimizer()),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.base_problem().minimizer().numpy(),
                               np.asarray(ref.base_problem().minimizer()), rtol=1e-9, atol=1e-12)
    assert got.dp_n == ref.dp_n == 30
    assert got.similarity_bound() == pytest.approx(ref.similarity_bound(), rel=1e-15)
    # the noise rides the gradient, not the Hessian
    np.testing.assert_allclose(got.hessian(torch.tensor(1), xt).numpy(),
                               got.base_problem().hessian(torch.tensor(1), xt).numpy(), rtol=0)


def test_clip_rows_and_the_native_builders(logistics):
    base, ref, _ = logistics
    Z = np.array(base.Z)
    np.testing.assert_allclose(tdp.clip_rows(torch.from_numpy(Z), 1.0).numpy(),
                               np.asarray(rdp.clip_rows(jnp.asarray(Z), 1.0)), rtol=1e-15)
    small = torch.full((2, 3), 0.1, dtype=torch.float64)
    assert torch.equal(tdp.clip_rows(small, 1.0), small)  # rows inside are untouched
    from repro_torch.problems import make_a9a_like_problem as t_a9a

    tbase = t_a9a(M, n_per_client=30, n_pool=300, dim=16, seed=2, device="cpu")
    native = tdp.make_dp_logistic(tbase, torch.Generator().manual_seed(12), sigma=2.0, clip=1.0)
    np.testing.assert_array_equal(native.Z.numpy(), np.asarray(ref.Z))  # same clipped data
    norms = torch.linalg.vector_norm(native.Z, dim=-1)
    assert float(norms.max()) <= 1.0 + 1e-12
    nu = 2.0 * 2.0 * 1.0 / 30
    assert native.dp_shift.shape == (M, 16)
    assert 0.5 * nu < float(native.dp_shift.std()) < 2.0 * nu  # N(0, nu^2) noise
    a9a = tdp.make_dp_a9a_problem(4, n_per_client=20, n_pool=200, dim=12, device="cpu")
    ref_a9a = rdp.make_dp_a9a_problem(4, n_per_client=20, n_pool=200, dim=12)
    np.testing.assert_array_equal(a9a.Z.numpy(), np.asarray(ref_a9a.Z))
    np.testing.assert_array_equal(a9a.y.numpy(), np.asarray(ref_a9a.y))
    qbase = make_synthetic_quadratic(num_clients=4, dim=5, seed=0)
    tq = problem_from_arrays("quadratic", {"A": qbase.A, "b": qbase.b}, device="cpu")
    dq = tdp.make_dp_quadratic(tq, sigma=1.0, clip=1.0, n_per_client=10)
    torch.testing.assert_close(dq.base_problem().b, tq.b, rtol=0, atol=1e-15)


@pytest.mark.parametrize("path", ["fused", "registry"])
def test_dp_logistic_svrp_matches_the_reference(logistics, path):
    """The fused path folds s_m into K2's target and starts from y0 = z;
    a planted fault (no fold) must leave the tolerance."""
    _, ref_p, got_p = logistics
    L = float(ref_p.smoothness_max())
    xl = ref_p.minimizer()
    if path == "fused":
        kw = dict(grid={"eta": [0.5, 1.0], "p": 0.3, "smoothness": L}, seeds=2, num_steps=25,
                  prox_solver="gd", prox_steps=15)
    else:
        kw = dict(grid={"eta": [0.5, 1.0], "p": 0.3}, seeds=2, num_steps=25,
                  prox_solver="newton-cg")
    ref = ref_run_batch("svrp", ref_p, x_star=xl, fused=path == "fused", **kw)
    draws = draws_from_numpy(*replay_draws("svrp", ref.seeds, M, kw, ref.hparams["p"]))
    run = lambda: run_batch("svrp", got_p, x_star=torch.from_numpy(np.array(xl)),  # noqa: E731
                            draws=draws, device="cpu", fused=path == "fused", **kw)
    got = run()
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(ref.comm))
    assert got.comm.dtype == torch.int32
    np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(ref.dist_sq), rtol=RTOL, atol=0)
    if path == "fused":
        plain = k2.logistic_prox_gd_indexed_plain
        k2.logistic_prox_gd_indexed_plain = (
            lambda Z, y, m, z, beta, ie, lam, steps, y0=None:
            plain(Z, y, m, z if y0 is None else y0, beta, ie, lam, steps))
        try:
            wrong = run()
        finally:
            k2.logistic_prox_gd_indexed_plain = plain
        assert not np.allclose(wrong.dist_sq.numpy(), np.asarray(ref.dist_sq), rtol=RTOL, atol=0)


def test_dp_problems_need_an_explicit_x_star(quads):
    ref, got = quads
    kw = dict(grid={"eta": 0.1, "p": 0.2}, num_steps=3)
    with pytest.raises(ValueError) as r:
        ref_run_batch("svrp", ref, **kw)
    with pytest.raises(ValueError) as t:
        run_batch("svrp", got, device="cpu", **kw)
    assert str(t.value) == str(r.value)
