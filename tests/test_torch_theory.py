"""The port's theorem table and constant estimators against `repro`.

`repro_torch.core.theory` (measure_constants, theory_grid, predict_comm,
predict_comm_for, predict_comm_bytes, predict_comm_bytes_for) and
`repro_torch.core.similarity` (grad_noise_at, empirical_delta,
empirical_smoothness) on the same small quadratic and logistic problems as
`repro.core`'s, and the grid `run_batch(stepsize="theory")` resolves.
Everything is float arithmetic on float64 inputs: held to 1e-12 relative.
The estimators take the reference's own point pairs (drawn from its keys
here), passed in as ``pairs``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as rcore  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.experiments import run_batch  # noqa: E402

REL = 1e-12
THEORY_ALGOS = ["sppm", "svrp", "svrp_minibatch", "catalyzed_svrp"]


@pytest.fixture(scope="module")
def problems():
    q = make_synthetic_quadratic(num_clients=10, dim=8, mu=1.0, L=80.0, delta=7.0, seed=0)
    lg = make_a9a_like_problem(num_clients=6, n_per_client=40, n_pool=300, dim=12,
                               nnz_per_row=4, seed=1)
    return {
        "quadratic": (q, problem_from_arrays(
            "quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)}, device="cpu")),
        "logistic": (lg, problem_from_arrays(
            "logistic", {"Z": np.asarray(lg.Z), "y": np.asarray(lg.y), "lam": lg.lam},
            device="cpu")),
    }


def _x_star(pair):
    ref_p, _ = pair
    xs = ref_p.minimizer()
    return xs, torch.as_tensor(np.array(xs))


@pytest.fixture(scope="module")
def constants(problems):
    out = {}
    for kind, pair in problems.items():
        xs, txs = _x_star(pair)
        out[kind] = (rcore.measure_constants(pair[0], x_star=xs),
                     tcore.measure_constants(pair[1], x_star=txs))
    return out


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_measure_constants_match(constants, kind):
    ref, port = constants[kind]
    assert port.M == ref.M
    for name in ("mu", "delta", "sigma_star_sq", "r0_sq"):
        assert getattr(port, name) == pytest.approx(getattr(ref, name), rel=REL), name


def test_measure_constants_with_x0(problems):
    ref_p, port_p = problems["quadratic"]
    x0 = np.linspace(-1.0, 1.0, 8)
    ref = rcore.measure_constants(ref_p, x0=jnp.asarray(x0))
    port = tcore.measure_constants(port_p, x0=torch.as_tensor(x0))
    assert port.r0_sq == pytest.approx(ref.r0_sq, rel=REL)


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
@pytest.mark.parametrize("algo", THEORY_ALGOS)
def test_theory_grid_matches(constants, algo, kind):
    ref_c, port_c = constants[kind]
    for eps in (1e-6, 1e-3):
        want = rcore.theory_grid(algo, None, eps=eps, constants=ref_c)
        got = tcore.theory_grid(algo, None, eps=eps, constants=port_c)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=REL), k


def test_theory_grid_measures_when_not_given_constants(problems):
    ref_p, port_p = problems["quadratic"]
    want, got = rcore.theory_grid("svrp", ref_p), tcore.theory_grid("svrp", port_p)
    assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
@pytest.mark.parametrize("algo", ["sppm", "svrp", "catalyzed_svrp"])
def test_predict_comm_matches(problems, constants, algo, kind):
    """On the same constants (the reference's): the two packages' measured
    constants differ in the last bits, and Catalyst's inner count
    ceil(3 / tau) sits exactly on an integer whenever gamma > 0
    (tau = 1/(2 (M + 1))), so one ulp can move it by one round."""
    ref_c, _ = constants[kind]
    port_c = tcore.ProblemConstants(*ref_c)
    for eps in (1e-10, 1e-4):
        kw = dict(mu=ref_c.mu, delta=ref_c.delta, M=ref_c.M, eps=eps,
                  sigma_star_sq=ref_c.sigma_star_sq, r0_sq=ref_c.r0_sq)
        assert tcore.predict_comm(algo, **kw) == pytest.approx(
            rcore.predict_comm(algo, **kw), rel=REL)
        assert tcore.predict_comm_for(problems[kind][1], algo, eps=eps, constants=port_c) == (
            pytest.approx(rcore.predict_comm_for(problems[kind][0], algo, eps=eps,
                                                 constants=ref_c), rel=REL))
        want = rcore.predict_comm_bytes_for(problems[kind][0], algo, eps=eps, constants=ref_c)
        got = tcore.predict_comm_bytes_for(problems[kind][1], algo, eps=eps, constants=port_c)
        assert got == pytest.approx(want, rel=REL)
        kw.update(dim=40, itemsize=8)
        assert tcore.predict_comm_bytes(algo, **kw) == pytest.approx(
            rcore.predict_comm_bytes(algo, **kw), rel=REL)


def test_theory_error_texts_match():
    calls = (lambda m: m.theory_grid("sgd", None),
             lambda m: m.predict_comm("svrp_minibatch", mu=1.0, delta=2.0, M=5, eps=1e-6))
    for call in calls:
        with pytest.raises(ValueError) as r:
            call(rcore)
        with pytest.raises(ValueError) as t:
            call(tcore)
        assert str(t.value) == str(r.value)
    # The lossy channels, ported since, price their bytes as the reference's do.
    for channel in ("quant8", "cast", "cast16"):
        kw = dict(mu=1.0, delta=2.0, M=5, eps=1e-6, dim=300, channel=channel)
        assert (tcore.predict_comm_bytes("svrp", **kw)
                == rcore.predict_comm_bytes("svrp", **kw))


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_grad_noise_at_matches(problems, kind):
    xs, txs = _x_star(problems[kind])
    for shift in (0.0, 0.5):
        want = float(rcore.grad_noise_at(problems[kind][0], xs + shift))
        got = float(tcore.grad_noise_at(problems[kind][1], txs + shift))
        assert got == pytest.approx(want, rel=REL)


def _reference_pairs(key, dim, num_pairs, radius):
    """The (x, y) pairs `repro.core.similarity` draws from ``key``."""
    def pair(k):
        kx, ky = jax.random.split(k)
        return (radius * jax.random.normal(kx, (dim,), dtype=jnp.float64),
                radius * jax.random.normal(ky, (dim,), dtype=jnp.float64))

    X, Y = jax.vmap(pair)(jax.random.split(key, num_pairs))
    return torch.as_tensor(np.array(X)), torch.as_tensor(np.array(Y))


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_estimators_on_reference_pairs(problems, kind):
    ref_p, port_p = problems[kind]
    key, n, radius = jax.random.key(4), 24, 0.7
    pairs = _reference_pairs(key, port_p.dim, n, radius)
    want = float(rcore.empirical_delta(ref_p, key, num_pairs=n, radius=radius))
    got = float(tcore.empirical_delta(port_p, pairs=pairs))
    assert got == pytest.approx(want, rel=REL)
    want = float(rcore.empirical_smoothness(ref_p, key, num_pairs=n, radius=radius))
    got = float(tcore.empirical_smoothness(port_p, pairs=pairs))
    assert got == pytest.approx(want, rel=REL)


def test_native_estimators_bound_the_exact_constants(problems):
    """With its own generator: the reference test's Monte-Carlo bounds."""
    _, port_p = problems["quadratic"]
    gen = torch.Generator().manual_seed(0)
    est = float(tcore.empirical_delta(port_p, gen, num_pairs=200))
    exact = float(port_p.similarity())
    assert 0.5 * exact <= est <= exact * (1 + 1e-6)
    est = float(tcore.empirical_smoothness(port_p, gen, num_pairs=100))
    assert 0.5 * float(port_p.smoothness()) <= est <= float(port_p.smoothness()) * (1 + 1e-6)


@pytest.mark.parametrize("algo", THEORY_ALGOS)
def test_stepsize_theory_resolves_the_reference_grid(problems, algo):
    """`stepsize="theory"` resolves the reference's trial table, and the
    grid's explicit entries override the theorem's."""
    ref_p, port_p = problems["quadratic"]
    static = {"sppm": dict(num_steps=4), "svrp": dict(num_steps=4),
              "svrp_minibatch": dict(num_steps=4, batch_clients=2),
              "catalyzed_svrp": dict(num_outer=1, inner_steps=4)}[algo]
    grid = {"p": 0.3} if algo != "sppm" else None
    ref = ref_run_batch(algo, ref_p, stepsize="theory", grid=grid, seeds=2, **static)
    port = run_batch(algo, port_p, stepsize="theory", grid=grid, seeds=2, device="cpu",
                     **static)
    assert set(port.hparams) == set(ref.hparams)
    for k, v in ref.hparams.items():
        np.testing.assert_allclose(port.hparams[k], v, rtol=REL, err_msg=k)
    assert np.isfinite(port.dist_sq.numpy()).all()


def test_stepsize_theory_for_a_baseline_raises_the_reference_text(problems):
    ref_p, port_p = problems["quadratic"]
    with pytest.raises(ValueError) as r:
        ref_run_batch("sgd", ref_p, stepsize="theory", num_steps=3)
    with pytest.raises(ValueError) as t:
        run_batch("sgd", port_p, stepsize="theory", num_steps=3, device="cpu")
    assert str(t.value) == str(r.value)
