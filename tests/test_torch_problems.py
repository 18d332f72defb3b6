"""The port's problems (`repro_torch.problems`) against `repro.problems`.

Generators are the reference's numpy code, so the same seed must give
bit-identical arrays.  Oracles, prox operators and constants are compared on
the same data (crossed over as numpy through `repro_torch.convert`), in
float64: closed-form oracles to rtol 1e-12, eigen-/Newton-based quantities
to rtol 1e-9 (LAPACK vs torch factorizations; guarded Newton stops at
||grad|| <= 1e-11).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.problems import (  # noqa: E402
    make_a9a_like_problem,
    make_ridge_problem,
    make_synthetic_quadratic,
)
from repro_torch import problems as tp  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402

EXACT = dict(rtol=1e-12, atol=1e-14)
SOLVED = dict(rtol=1e-9, atol=1e-11)
M, D = 10, 6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def quad():
    ref = make_synthetic_quadratic(num_clients=M, dim=D, mu=1.0, L=80.0, delta=4.0, seed=1)
    port = problem_from_arrays("quadratic", {"A": np.asarray(ref.A), "b": np.asarray(ref.b)},
                               device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def logi():
    ref = make_a9a_like_problem(num_clients=5, n_per_client=40, n_pool=300, dim=12,
                                nnz_per_row=4, seed=1)
    port = problem_from_arrays(
        "logistic", {"Z": np.asarray(ref.Z), "y": np.asarray(ref.y), "lam": ref.lam}, device="cpu"
    )
    return ref, port


def _inputs(batch, dim, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, M, size=batch)
    x = rng.standard_normal((batch, dim))
    return m, x


# ------------------------------------------------------------------ generators
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_quadratic_bit_identical(seed):
    ref = make_synthetic_quadratic(num_clients=M, dim=D, mu=1.0, L=80.0, delta=4.0, seed=seed)
    port = tp.make_synthetic_quadratic(M, D, mu=1.0, L=80.0, delta=4.0, seed=seed, device="cpu")
    assert np.array_equal(np.asarray(ref.A), _np(port.A))
    assert np.array_equal(np.asarray(ref.b), _np(port.b))
    assert port.A.dtype == torch.float64


@pytest.mark.parametrize("seed", [0, 2])
def test_a9a_like_bit_identical(seed):
    kw = dict(num_clients=4, n_per_client=30, n_pool=200, dim=10, nnz_per_row=3, seed=seed)
    ref = make_a9a_like_problem(**kw)
    port = tp.make_a9a_like_problem(**kw, device="cpu")
    assert np.array_equal(np.asarray(ref.Z), _np(port.Z))
    assert np.array_equal(np.asarray(ref.y), _np(port.y))
    assert port.lam == ref.lam


def test_ridge_bit_identical():
    rng = np.random.default_rng(7)
    Z, y = rng.standard_normal((3, 20, 5)), rng.standard_normal((3, 20))
    ref = make_ridge_problem(Z, y, lam=0.1)
    port = tp.make_ridge_problem(Z, y, lam=0.1, device="cpu")
    assert np.array_equal(np.asarray(ref.A), _np(port.A))
    assert np.array_equal(np.asarray(ref.b), _np(port.b))


def test_generators_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.make_synthetic_quadratic(M, D, seed=0)


# ------------------------------------------------------------------- quadratic
@pytest.mark.parametrize("oracle", ["grad", "hessian", "loss"])
def test_quadratic_client_oracles(quad, oracle):
    ref, port = quad
    m, x = _inputs(4, D)
    want = jax.vmap(getattr(ref, oracle))(jnp.asarray(m), jnp.asarray(x))
    got = getattr(port, oracle)(torch.as_tensor(m), torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)


@pytest.mark.parametrize("oracle", ["full_grad", "full_loss"])
def test_quadratic_full_oracles(quad, oracle):
    ref, port = quad
    _, x = _inputs(3, D, seed=1)
    want = jax.vmap(getattr(ref, oracle))(jnp.asarray(x))
    np.testing.assert_allclose(_np(getattr(port, oracle)(torch.as_tensor(x))), np.asarray(want),
                               **EXACT)


def test_quadratic_local_oracle(quad):
    ref, port = quad
    m, x = _inputs(4, D, seed=2)
    g_t, h_t = port.local_oracle(torch.as_tensor(m))
    for b in range(4):
        g_r, h_r = ref.local_oracle(int(m[b]))
        np.testing.assert_allclose(_np(g_t(torch.as_tensor(x))[b]), np.asarray(g_r(x[b])), **EXACT)
        np.testing.assert_allclose(_np(h_t(torch.as_tensor(x))[b]), np.asarray(h_r(x[b])), **EXACT)


@pytest.mark.parametrize("kind", ["exact", "spectral"])
def test_quadratic_prox(quad, kind):
    ref, port = quad
    m, z = _inputs(4, D, seed=3)
    eta = np.array([0.05, 0.1, 0.5, 2.0])
    if kind == "exact":
        want = jax.vmap(ref.prox)(jnp.asarray(m), jnp.asarray(z), jnp.asarray(eta))
        got = port.prox(torch.as_tensor(m), torch.as_tensor(z), torch.as_tensor(eta))
    else:
        fr, fp = ref.prox_factors(), port.prox_factors()
        want = jax.vmap(lambda mm, zz, ee: ref.prox_spectral(mm, zz, ee, fr))(
            jnp.asarray(m), jnp.asarray(z), jnp.asarray(eta))
        got = port.prox_spectral(torch.as_tensor(m), torch.as_tensor(z), torch.as_tensor(eta), fp)
    np.testing.assert_allclose(_np(got), np.asarray(want), **SOLVED)
    # single client, scalar eta
    np.testing.assert_allclose(
        _np(port.prox(torch.tensor(2), torch.as_tensor(z[0]), 0.3)),
        np.asarray(ref.prox(2, jnp.asarray(z[0]), 0.3)), **SOLVED)


def test_quadratic_shifted(quad):
    ref, port = quad
    y = np.random.default_rng(4).standard_normal(D)
    r, p = ref.shifted(0.7, jnp.asarray(y)), port.shifted(0.7, torch.as_tensor(y))
    np.testing.assert_allclose(_np(p.A), np.asarray(r.A), **EXACT)
    np.testing.assert_allclose(_np(p.b), np.asarray(r.b), **EXACT)


@pytest.mark.parametrize("const", [
    "minimizer", "smoothness", "smoothness_max", "strong_convexity", "similarity",
    "similarity_max", "grad_noise_at_opt",
])
def test_quadratic_constants(quad, const):
    ref, port = quad
    np.testing.assert_allclose(_np(getattr(port, const)()), np.asarray(getattr(ref, const)()),
                               **SOLVED)


# -------------------------------------------------------------------- logistic
@pytest.mark.parametrize("oracle", ["grad", "hessian", "loss"])
def test_logistic_client_oracles(logi, oracle):
    ref, port = logi
    rng = np.random.default_rng(5)
    m, x = rng.integers(0, 5, size=3), rng.standard_normal((3, 12))
    want = jax.vmap(getattr(ref, oracle))(jnp.asarray(m), jnp.asarray(x))
    got = getattr(port, oracle)(torch.as_tensor(m), torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)


@pytest.mark.parametrize("oracle", ["full_grad", "full_loss"])
def test_logistic_full_oracles(logi, oracle):
    ref, port = logi
    x = np.random.default_rng(6).standard_normal((2, 12))
    want = jax.vmap(getattr(ref, oracle))(jnp.asarray(x))
    np.testing.assert_allclose(_np(getattr(port, oracle)(torch.as_tensor(x))), np.asarray(want),
                               **EXACT)


def test_logistic_local_oracle(logi):
    ref, port = logi
    x = np.random.default_rng(7).standard_normal(12)
    g_t, h_t = port.local_oracle(torch.tensor(3))
    g_r, h_r = ref.local_oracle(3)
    np.testing.assert_allclose(_np(g_t(torch.as_tensor(x))), np.asarray(g_r(jnp.asarray(x))), **EXACT)
    np.testing.assert_allclose(_np(h_t(torch.as_tensor(x))), np.asarray(h_r(jnp.asarray(x))), **EXACT)


@pytest.mark.parametrize("eta", [0.5, 50.0])
def test_logistic_guarded_newton_prox(logi, eta):
    """Single client and a batch of lanes (each lane stops on its own)."""
    ref, port = logi
    rng = np.random.default_rng(8)
    z = rng.standard_normal((3, 12)) * 2.0
    m = np.array([0, 2, 4])
    want = jax.vmap(lambda mm, zz: ref.prox(mm, zz, eta))(jnp.asarray(m), jnp.asarray(z))
    got = port.prox(torch.as_tensor(m), torch.as_tensor(z), eta)
    np.testing.assert_allclose(_np(got), np.asarray(want), **SOLVED)
    np.testing.assert_allclose(_np(port.prox(torch.tensor(1), torch.as_tensor(z[1]), eta)),
                               np.asarray(ref.prox(1, jnp.asarray(z[1]), eta)), **SOLVED)


def test_logistic_shifted(logi):
    ref, port = logi
    rng = np.random.default_rng(9)
    anchor, x = rng.standard_normal(12), rng.standard_normal(12)
    r, p = ref.shifted(0.4, jnp.asarray(anchor)), port.shifted(0.4, torch.as_tensor(anchor))
    np.testing.assert_allclose(_np(p.grad(torch.tensor(2), torch.as_tensor(x))),
                               np.asarray(r.grad(2, jnp.asarray(x))), **EXACT)
    np.testing.assert_allclose(_np(p.full_grad(torch.as_tensor(x))),
                               np.asarray(r.full_grad(jnp.asarray(x))), **EXACT)
    np.testing.assert_allclose(_np(p.prox(torch.tensor(2), torch.as_tensor(x), 1.5)),
                               np.asarray(r.prox(2, jnp.asarray(x), 1.5)), **SOLVED)


@pytest.mark.parametrize("const", ["minimizer", "smoothness", "smoothness_max", "strong_convexity"])
def test_logistic_constants(logi, const):
    ref, port = logi
    np.testing.assert_allclose(_np(getattr(port, const)()), np.asarray(getattr(ref, const)()),
                               **SOLVED)


@pytest.mark.parametrize("const", ["similarity_at", "similarity_max_at"])
def test_logistic_measured_similarity(logi, const):
    ref, port = logi
    x = np.array(ref.minimizer())
    np.testing.assert_allclose(_np(getattr(port, const)(torch.as_tensor(x))),
                               np.asarray(getattr(ref, const)(jnp.asarray(x))), **SOLVED)
