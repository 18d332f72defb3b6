"""The port's baselines (`repro_torch.core.baselines`) against `repro.core.baselines`.

SGD, loopless SVRG, SCAFFOLD, DANE and accelerated extragradient: each
``run_*`` driver of the port, on the CPU, against the reference's with the
reference's draws replayed from the same key (tests/_torch_replay.py), on a
small quadratic (M 12, d 8) and a small logistic problem (SGD, SVRG and
SCAFFOLD on its gradients, the surrogate methods by guarded Newton).  Then the quickstart twin
(examples/quickstart_torch.py) runs its three drivers at 300 rounds against
`repro`'s `run_svrp`, `run_svrg` and `run_sgd` with the same keys.

Tolerances: ``comm`` integer-equal with equal dtype; dist_sq and x_final
rtol 1e-6 above an atol floor of 1e-24 (the reference's engine tolerance
for closed-form solves); the logistic surrogates, solved by
guarded Newton to 1e-11, rtol 1e-4 above a 1e-20 floor.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import replay_trial  # noqa: E402

import repro.core as rcore  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402

M, D = 12, 8
EXACT = dict(rtol=1e-6, atol=1e-24)
NEWTON = dict(rtol=1e-4, atol=1e-20)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def quad():
    q = make_synthetic_quadratic(num_clients=M, dim=D, mu=1.0, L=60.0, delta=3.0, seed=4)
    return q, problem_from_arrays("quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)},
                                  device="cpu")


@pytest.fixture(scope="module")
def logi():
    lg = make_a9a_like_problem(num_clients=6, n_per_client=40, n_pool=300, dim=10,
                               nnz_per_row=4, seed=2)
    return lg, problem_from_arrays(
        "logistic", {"Z": np.asarray(lg.Z), "y": np.asarray(lg.y), "lam": lg.lam}, device="cpu")


def _check(port, ref, tol):
    ref_comm = np.asarray(ref.comm)
    np.testing.assert_array_equal(port.comm.numpy(), ref_comm)
    assert port.comm.numpy().dtype == ref_comm.dtype
    np.testing.assert_allclose(port.dist_sq.numpy(), np.asarray(ref.dist_sq), **tol)
    np.testing.assert_allclose(port.x_final.numpy(), np.asarray(ref.x_final),
                               rtol=tol["rtol"], atol=1e-12)


def _both(pair, x_star=None):
    """(reference args, port args): problem, x0 = 0, x_star."""
    ref_p, port_p = pair
    xs = ref_p.minimizer() if x_star is None else x_star
    return ((ref_p, jnp.zeros(ref_p.dim), xs),
            (port_p, torch.zeros(port_p.dim, dtype=torch.float64),
             torch.as_tensor(np.array(xs))))


def _hp(quad):
    q, _ = quad
    L = float(q.smoothness_max())
    return {
        "sgd": dict(stepsize=1 / (3 * L), num_steps=120),
        "svrg": dict(stepsize=1 / (6 * L), p=0.2, num_steps=120),
        "scaffold": dict(local_lr=1 / (4 * L), global_lr=0.7, local_steps=3, num_rounds=50),
        "dane": dict(theta=float(q.similarity_max()), num_rounds=12, surrogate_client=3),
        "acc_extragradient": dict(theta=float(q.similarity_max()),
                                  mu=float(q.strong_convexity()), num_rounds=12),
    }


@pytest.mark.parametrize("algo,seed", [(a, s) for a in ("sgd", "svrg", "scaffold")
                                       for s in (0, 3)]
                         + [("dane", None), ("acc_extragradient", None)])
def test_baseline_matches_reference(quad, algo, seed):
    kw = _hp(quad)[algo]
    (rp, rx0, rxs), (pp, px0, pxs) = _both(quad)
    name = f"run_{algo}"
    if seed is None:  # deterministic: no key
        ref = getattr(rcore, name)(rp, rx0, rxs, **kw)
        port = getattr(tcore, name)(pp, px0, pxs, device="cpu", **kw)
    else:
        ref = getattr(rcore, name)(rp, rx0, rxs, key=jax.random.key(seed), **kw)
        draws = replay_trial(algo, seed, M, kw, kw.get("p"))
        port = getattr(tcore, name)(pp, px0, pxs, draws=draws, device="cpu", **kw)
    _check(port, ref, EXACT)


@pytest.mark.parametrize("algo", ["dane", "acc_extragradient"])
def test_surrogate_methods_on_logistic_match_reference(logi, algo):
    """Non-quadratic: the surrogate argmin by guarded Newton."""
    lg, _ = logi
    kw = dict(theta=1.0, num_rounds=6)
    if algo == "acc_extragradient":
        kw["mu"] = lg.lam
    (rp, rx0, rxs), (pp, px0, pxs) = _both(logi)
    ref = getattr(rcore, f"run_{algo}")(rp, rx0, rxs, **kw)
    port = getattr(tcore, f"run_{algo}")(pp, px0, pxs, device="cpu", **kw)
    _check(port, ref, NEWTON)


@pytest.mark.parametrize("algo", ["sgd", "svrg", "scaffold"])
def test_sampling_methods_on_logistic_match_reference(logi, algo):
    """Non-quadratic gradients with the reference's draws replayed from
    ``key(1)``; every step is closed form, so the quadratic's tolerance."""
    lg, _ = logi
    L = float(lg.smoothness_max())
    kw = {"sgd": dict(stepsize=1 / (2 * L), num_steps=60),
          "svrg": dict(stepsize=1 / (6 * L), p=0.3, num_steps=60),
          "scaffold": dict(local_lr=1 / (4 * L), global_lr=1.0, local_steps=3,
                           num_rounds=30)}[algo]
    (rp, rx0, rxs), (pp, px0, pxs) = _both(logi)
    ref = getattr(rcore, f"run_{algo}")(rp, rx0, rxs, key=jax.random.key(1), **kw)
    draws = replay_trial(algo, 1, lg.num_clients, kw, kw.get("p"))
    port = getattr(tcore, f"run_{algo}")(pp, px0, pxs, draws=draws, device="cpu", **kw)
    _check(port, ref, EXACT)
    assert float(port.dist_sq[-1]) < float(port.dist_sq[0])


def test_svrg_refresh_only_on_coin_rounds(quad, monkeypatch):
    """L-SVRG recomputes the anchor gradient only on rounds whose coin says
    so: the host knows the coins, so no round asks the device."""
    _, pp = quad
    calls = []
    full_grad = type(pp).full_grad
    monkeypatch.setattr(type(pp), "full_grad",
                        lambda self, x: calls.append(1) or full_grad(self, x))
    draws = tcore.draw_schedule([0], M, 60, 0.1).trial(0)
    px0 = torch.zeros(D, dtype=torch.float64)
    tcore.run_svrg(pp, px0, pp.minimizer(), stepsize=1e-3, p=0.1, num_steps=60, draws=draws,
                   device="cpu")
    assert len(calls) == 1 + int(draws.coins.sum())  # the init anchor + each refresh


def _quickstart():
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  REPO / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_matches_reference():
    """The twin's three drivers at 300 rounds against `repro`'s, with the keys
    examples/quickstart.py uses (``jax.random.key(0)`` for all three)."""
    qs = _quickstart()
    horizons = dict.fromkeys(qs.HORIZONS, 300)
    ref_p = make_synthetic_quadratic(num_clients=qs.M, dim=qs.DIM, mu=1.0, L=2000.0, delta=8.0,
                                     seed=0)
    M_ = qs.M
    draws = {"SVRP": replay_trial("svrp", 0, M_, {"num_steps": 300}, 1 / M_),
             "SVRG": replay_trial("svrg", 0, M_, {"num_steps": 300}, 1 / M_),
             "SGD": replay_trial("sgd", 0, M_, {"num_steps": 300})}
    out = qs.run("cpu", horizons, draws=draws)
    port_p = qs.make_problem("cpu")
    mu, delta, L = (float(ref_p.strong_convexity()), float(ref_p.similarity()),
                    float(ref_p.smoothness_max()))
    assert (float(port_p.strong_convexity()), float(port_p.similarity()),
            float(port_p.smoothness_max())) == pytest.approx((mu, delta, L), rel=1e-12)
    x0, xs, key = jnp.zeros(qs.DIM), ref_p.minimizer(), jax.random.key(0)
    ref = {
        "SVRP": rcore.run_svrp(ref_p, x0, xs, eta=rcore.theorem2_stepsize(mu, delta), p=1 / M_,
                               num_steps=300, key=key),
        "SVRG": rcore.run_svrg(ref_p, x0, xs, stepsize=1 / (6 * L), p=1 / M_, num_steps=300,
                               key=key),
        "SGD": rcore.run_sgd(ref_p, x0, xs, stepsize=1 / (2 * L), num_steps=300, key=key),
    }
    for name, res in out.items():
        _check(res, ref[name], EXACT)


def test_quickstart_twin_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _quickstart().run(None, dict.fromkeys(("SVRP", "SVRG", "SGD"), 2))


def test_fed_a9a_twin_runs():
    """examples/fed_a9a_torch.py at a small size on the CPU: both panels'
    sweeps run, and SVRP ends nearer the optimum than L-SVRG at the budget."""
    spec = importlib.util.spec_from_file_location("fed_a9a_torch",
                                                  REPO / "examples" / "fed_a9a_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    panels = mod.main(["--clients", "6", "--comm-budget", "600", "--seeds", "2",
                       "--n-per-client", "100", "--device", "cpu"])
    for runs in panels.values():
        svrp, svrg = (runs[k].final_at_budget(600) for k in ("svrp", "svrg"))
        assert np.isfinite(svrp) and svrp < svrg
