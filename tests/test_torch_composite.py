"""The port's composite SVRP (Algorithm 4) against `repro`, on the CPU in float64.

The proxes of R (l1, box, l2 ball), lane-batched against the reference's
per-trial `vmap`; FISTA's joint prox and the proximal-gradient minimizer;
and `run_batch`, `run_sequential` and `run_composite_svrp` on the small
quadratic (M 10, d 6) with the reference's draws replayed: comm equal,
dist_sq rtol 1e-9 above a 1e-20 floor (sequential against the lane batch
rtol 1e-6).  The floor: both runs converge to the constrained optimum, where
their iterates agree to ~1e-17 (a few ulps of |x| ~ 2e-2), which moves
dist_sq by about 2 sqrt(dist_sq) 1e-17 -- 1e-22 at dist_sq 1e-10.
The constraints are set to bind at the solution (radius and box half the
unconstrained minimizer's norm and largest entry).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import draws_from_numpy, replay_draws, replay_trial  # noqa: E402
from repro.core import composite as rcomp  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.problems import make_synthetic_quadratic  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import composite as tcomp  # noqa: E402
from repro_torch.experiments import run_batch, run_sequential  # noqa: E402

M = 10
RTOL = 1e-9
TRAJ_TOL = dict(rtol=RTOL, atol=1e-20)
PATH_TOL = dict(rtol=1e-6, atol=1e-20)
L1_WEIGHT = 0.05


@pytest.fixture(scope="module")
def quad():
    q = make_synthetic_quadratic(num_clients=M, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1)
    pq = problem_from_arrays("quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)},
                             device="cpu")
    return q, pq


@pytest.fixture(scope="module")
def regularizers(quad):
    """name -> (reference prox, port prox), binding at the solution."""
    q, _ = quad
    x_unc = np.asarray(q.minimizer())
    r, box = 0.5 * float(np.linalg.norm(x_unc)), 0.5 * float(np.abs(x_unc).max())
    return {
        "l1": (lambda z, t: rcomp.prox_l1(z, L1_WEIGHT * t),
               lambda z, t: tcomp.prox_l1(z, L1_WEIGHT * t)),
        "box": (rcomp.prox_box(-box, box), tcomp.prox_box(-box, box)),
        "l2ball": (rcomp.prox_l2ball(r), tcomp.prox_l2ball(r)),
    }


@pytest.fixture(scope="module")
def minimizers(quad, regularizers):
    q, pq = quad
    L = float(q.smoothness())
    return {name: (rcomp.composite_minimizer_pgd(q, rp, L=L, num_steps=3000),
                   tcomp.composite_minimizer_pgd(pq, tp, L=L, num_steps=3000))
            for name, (rp, tp) in regularizers.items()}


@pytest.mark.parametrize("name", ["l1", "box", "l2ball"])
def test_prox_of_r_over_lanes(regularizers, name):
    """(B, d) lanes with a per-lane step, against the reference per trial;
    the l2 ball takes one norm per lane."""
    rp, tp = regularizers[name]
    rng = np.random.default_rng(4)
    z = rng.standard_normal((5, 6)) * np.array([0.01, 0.1, 1.0, 3.0, 10.0])[:, None]
    t = rng.uniform(0.01, 0.5, size=5)
    want = np.asarray(jax.vmap(rp)(jnp.asarray(z), jnp.asarray(t)))
    got = tp(torch.from_numpy(z), torch.from_numpy(t)[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-300)
    assert not np.allclose(got.numpy(), z)  # some lanes are moved


def test_joint_prox_fista_over_lanes(quad, regularizers):
    q, pq = quad
    rp, tp = regularizers["l2ball"]
    rng = np.random.default_rng(5)
    z, m = rng.standard_normal((3, 6)), np.array([0, 4, 9])
    eta = np.array([0.01, 0.05, 0.2])
    L = float(q.smoothness_max())

    def one(mi, zi, ei):
        return rcomp.joint_prox_fista(lambda y: q.grad(mi, y), rp, zi, ei, L, 1.0, 60)

    want = np.asarray(jax.vmap(one)(jnp.asarray(m), jnp.asarray(z), jnp.asarray(eta)))
    mt = torch.from_numpy(m)
    got = tcomp.joint_prox_fista(lambda y: pq.grad(mt, y), tp, torch.from_numpy(z),
                                 torch.from_numpy(eta), L, 1.0, 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("name", ["l1", "box", "l2ball"])
def test_composite_minimizer_pgd(quad, minimizers, name):
    q, pq = quad
    want, got = minimizers[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-14)
    assert not np.allclose(np.asarray(want), np.asarray(q.minimizer()), atol=1e-6)  # it binds


@pytest.mark.parametrize("name", ["l1", "box", "l2ball"])
def test_composite_sweep_matches_the_reference(quad, regularizers, minimizers, name):
    q, pq = quad
    rp, tp = regularizers[name]
    xs = minimizers[name][0]
    txs = torch.from_numpy(np.array(xs))  # both runs measure to the same point
    L = float(q.smoothness_max())
    kw = dict(grid={"eta": [0.02, 0.05], "p": 0.3, "smoothness": L, "mu": 1.0}, seeds=2,
              num_steps=40)
    ref = ref_run_batch("composite", q, x_star=xs, prox_R=rp, **kw)
    draws = draws_from_numpy(*replay_draws("composite", ref.seeds, M, kw, ref.hparams["p"]))
    got = run_batch("composite", pq, x_star=txs, prox_R=tp, draws=draws, device="cpu", **kw)
    assert got.comm.dtype == torch.int32
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(ref.comm))
    np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(ref.dist_sq), **TRAJ_TOL)
    seq = run_sequential("composite", pq, x_star=txs, prox_R=tp, draws=draws, device="cpu", **kw)
    np.testing.assert_array_equal(seq.comm.numpy(), got.comm.numpy())
    np.testing.assert_allclose(seq.dist_sq.numpy(), got.dist_sq.numpy(), **PATH_TOL)
    assert (got.dist_sq.numpy()[:, -1] < got.dist_sq.numpy()[:, 0]).all()


def test_run_composite_svrp_matches_the_reference(quad, regularizers, minimizers):
    q, pq = quad
    rp, tp = regularizers["l2ball"]
    xs = minimizers["l2ball"][0]
    txs = torch.from_numpy(np.array(xs))
    L = float(q.smoothness_max())
    kw = dict(eta=0.05, p=0.3, num_steps=30, smoothness=L, mu=1.0)
    ref = rcomp.run_composite_svrp(q, rp, jnp.zeros(6), xs, key=jax.random.key(3), **kw)
    draws = replay_trial("composite", 3, M, {"num_steps": 30}, 0.3)
    got = tcomp.run_composite_svrp(pq, tp, torch.zeros(6, dtype=torch.float64), txs,
                                   draws=draws, device="cpu", **kw)
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(ref.comm))
    np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(ref.dist_sq), **TRAJ_TOL)
    native = tcomp.run_composite_svrp(pq, tp, torch.zeros(6, dtype=torch.float64), txs,
                                      seed=3, device="cpu", **kw)
    assert native.dist_sq.shape == (30,) and np.isfinite(native.dist_sq.numpy()).all()


def test_composite_needs_an_explicit_x_star(quad):
    q, pq = quad
    kw = dict(grid={"eta": 0.05, "p": 0.3, "smoothness": 1.0, "mu": 1.0}, num_steps=3)
    with pytest.raises(ValueError) as r:
        ref_run_batch("composite", q, prox_R=rcomp.prox_l1, **kw)
    with pytest.raises(ValueError) as t:
        run_batch("composite", pq, prox_R=tcomp.prox_l1, device="cpu", **kw)
    assert str(t.value) == str(r.value)
