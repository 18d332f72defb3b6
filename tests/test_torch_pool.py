"""The port's `SessionPool` against standalone sessions and `repro`'s pool.

The twin of tests/test_pool.py's contract: a pooled tenant's trajectory
equals its standalone `FedSession` — dist_sq and x to rtol 1e-5 (above a
1e-24 floor), comm and comm_bytes integer-exact with equal dtypes — for
every `ALGOS` entry (sppm, svrp and svrp_minibatch on the quadratic take
the stacked tick, one lane batch for every tenant; the others step tenant
by tenant), on distinct problems, with a tenant admitted mid-run, after an
eviction (the evicted slot adds zero to the tick's outputs and to the bytes
totals), with `stop_eps` freezing only its own lane, and with per-tenant
horizons; plus the admission checks, `FedRoundServer(pool=...)`, and one
pool against the reference's pool with its draws replayed.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_replay import draws_from_numpy, replay_draws  # noqa: E402

from repro.core import catalyst_inner_iterations, theorem2_stepsize, theorem3_gamma  # noqa: E402
from repro.problems import make_synthetic_quadratic as ref_make_quadratic  # noqa: E402
from repro.serve import SessionPool as RefSessionPool  # noqa: E402
from repro_torch.core import composite as tcomp  # noqa: E402
from repro_torch.experiments import ALGOS, RunSpec  # noqa: E402
from repro_torch.experiments.spec import check_pool_entry, pool_entry_signature  # noqa: E402
from repro_torch.problems import make_synthetic_quadratic  # noqa: E402
from repro_torch.serve import FedRoundServer, SessionPool, open_session  # noqa: E402

M = 10
SEEDS = 2


def _quad(seed, dim=6):
    return make_synthetic_quadratic(num_clients=M, dim=dim, mu=1.0, L=80.0, delta=4.0, seed=seed,
                                    device="cpu")


@pytest.fixture(scope="module")
def prob():
    return _quad(1)


@pytest.fixture(scope="module")
def prob2():
    """Same shapes as `prob`, different data."""
    return _quad(7)


@pytest.fixture(scope="module")
def cases(prob):
    mu, delta = float(prob.strong_convexity()), float(prob.similarity())
    dmax, L = float(prob.similarity_max()), float(prob.smoothness_max())
    eta = theorem2_stepsize(mu, delta)
    gamma = max(theorem3_gamma(mu, delta, M), 0.5)
    inner = min(catalyst_inner_iterations(mu, delta, M), 12)
    prox_R = tcomp.prox_l2ball(0.1)
    x_star_c = tcomp.composite_minimizer_pgd(prob, prox_R, L=float(prob.smoothness()),
                                             num_steps=3000)
    return {
        "sppm": dict(grid={"eta": [0.05, 0.1]}, seeds=SEEDS, num_steps=12),
        "svrp": dict(grid={"eta": [eta, eta / 2], "p": 0.2}, seeds=SEEDS, num_steps=12),
        "svrp_minibatch": dict(grid={"eta": 3 * eta, "p": 0.25}, seeds=SEEDS, num_steps=12,
                               batch_clients=3),
        "catalyzed_svrp": dict(grid={"mu": mu, "gamma": gamma,
                                     "eta": theorem2_stepsize(mu + gamma, delta), "p": 1 / M},
                               seeds=SEEDS, num_outer=2, inner_steps=inner),
        "deep_svrp": dict(grid={"eta": 0.5, "local_lr": 0.8 / (L + 2.0), "anchor_prob": 0.25},
                          seeds=SEEDS, num_steps=12, local_steps=4),
        "sgd": dict(grid={"stepsize": 1 / (3 * L)}, seeds=SEEDS, num_steps=12),
        "svrg": dict(grid={"stepsize": 1 / (6 * L), "p": 0.2}, seeds=SEEDS, num_steps=12),
        "scaffold": dict(grid={"local_lr": 1 / (4 * L)}, seeds=SEEDS, num_rounds=12,
                         local_steps=4),
        "dane": dict(grid={"theta": dmax}, num_rounds=8),
        "acc_extragradient": dict(grid={"theta": dmax, "mu": mu}, num_rounds=8),
        "composite": dict(grid={"eta": [eta, eta / 2], "p": 0.2, "smoothness": L, "mu": mu},
                          seeds=SEEDS, num_steps=12, prox_R=prox_R, x_star=x_star_c),
    }


def _variant(kw):
    """Same shapes and static config, the first grid axis scaled by 0.9."""
    kw = copy.copy(kw)
    grid = dict(kw["grid"])
    name = next(iter(grid))
    v = grid[name]
    grid[name] = [x * 0.9 for x in v] if isinstance(v, list) else v * 0.9
    kw["grid"] = grid
    return kw


def _assert_tenant_equal(pool_res, session):
    np.testing.assert_allclose(pool_res.dist_sq.numpy(), session.dist_sq.numpy(), rtol=1e-5,
                               atol=1e-24)
    assert torch.equal(pool_res.comm, session.comm) and pool_res.comm.dtype == session.comm.dtype
    np.testing.assert_array_equal(pool_res.comm_bytes, session.comm_bytes)
    assert pool_res.comm_bytes.dtype == session.comm_bytes.dtype
    np.testing.assert_allclose(pool_res.x_final.numpy(), session.x().numpy(), rtol=1e-5,
                               atol=1e-12)


def _session(algo, problem, kw, rounds=None):
    s = open_session(algo, problem, device="cpu", **kw)
    s.step(s.horizon if rounds is None else rounds)
    return s


def test_every_algo_has_a_pool_case(cases):
    assert set(cases) == set(ALGOS)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_pooled_lane_matches_standalone_session(algo, prob, prob2, cases):
    kw, kw2 = cases[algo], _variant(cases[algo])
    pool = SessionPool(capacity=3)  # one slot deliberately left empty
    a = pool.admit(algo, prob, device="cpu", **kw)
    b = pool.admit(algo, prob2 if algo != "composite" else prob, device="cpu", **kw2)
    assert pool.stacked == (algo in ("sppm", "svrp", "svrp_minibatch"))
    horizon = pool.session(a).horizon
    k1 = max(1, horizon // 3)
    d2, comm = pool.step(k1)
    assert d2.shape == comm.shape == (3, pool.session(a).num_trials, k1)
    d2, comm = pool.step(horizon - k1)
    _assert_tenant_equal(pool.result(a), _session(algo, prob, kw))
    _assert_tenant_equal(pool.result(b), _session(algo, prob2 if algo != "composite" else prob,
                                                  kw2))
    assert not d2[2].any() and not comm[2].any()  # the empty slot: zero


def test_pool_handles_distinct_problems(prob, prob2, cases):
    kw = cases["svrp"]
    pool = SessionPool(capacity=2)
    a = pool.admit("svrp", prob, device="cpu", **kw)
    b = pool.admit("svrp", prob2, device="cpu", **kw)
    pool.step(12)
    _assert_tenant_equal(pool.result(a), _session("svrp", prob, kw))
    _assert_tenant_equal(pool.result(b), _session("svrp", prob2, kw))


def test_mid_run_admission_starts_its_own_record(prob, cases):
    kw, kw2 = cases["svrp"], _variant(cases["svrp"])
    pool = SessionPool(capacity=2)
    a = pool.admit("svrp", prob, device="cpu", **kw)
    pool.step(7)
    b = pool.admit("svrp", prob, device="cpu", **kw2)
    pool.step(5)  # a reaches its 12-round horizon; b is at round 5
    _assert_tenant_equal(pool.result(a), _session("svrp", prob, kw))
    _assert_tenant_equal(pool.result(b), _session("svrp", prob, kw2, rounds=5))


def test_evicted_lane_contributes_zero_bytes(prob, cases):
    kw, kw2 = cases["svrp"], _variant(cases["svrp"])
    pool = SessionPool(capacity=2)
    a = pool.admit("svrp", prob, device="cpu", **kw)
    b = pool.admit("svrp", prob, device="cpu", **kw2)
    pool.step(6)
    bytes_a = int(pool.session(a).comm_bytes[:, -1].sum())
    ses_a = pool.evict(a)
    d2, comm = pool.step(6)
    assert not d2[0].any() and not comm[0].any()
    assert int(ses_a.comm_bytes[:, -1].sum()) == bytes_a
    assert pool.total_comm_bytes == bytes_a + int(pool.session(b).comm_bytes[:, -1].sum())
    assert ses_a.t == 6  # the evicted session goes on alone, from its own state and record
    ses_a.step(6)
    ref = _session("svrp", prob, kw)
    np.testing.assert_allclose(ses_a.dist_sq.numpy(), ref.dist_sq.numpy(), rtol=1e-5, atol=1e-24)
    assert torch.equal(ses_a.comm, ref.comm)


def test_stop_eps_freezes_only_its_lane(prob):
    eta = theorem2_stepsize(1.0, float(prob.similarity()))
    pool = SessionPool(capacity=2)
    fast = pool.admit("svrp", prob, grid={"eta": eta, "p": 0.2}, seeds=SEEDS, num_steps=400,
                      stop_eps=1e-10, device="cpu")
    slow = pool.admit("svrp", prob, grid={"eta": eta * 1e-4, "p": 0.2}, seeds=SEEDS,
                      num_steps=400, device="cpu")
    while not pool.is_frozen(fast):
        pool.step(50)
    t_frozen = pool.session(fast).t
    assert t_frozen < 400
    assert (pool.session(fast).dist_sq.numpy().min(axis=1) <= 1e-10).all()
    bytes_frozen = pool.session(fast).comm_bytes.copy()
    d2, comm = pool.step(50)
    assert not d2[0].any() and not comm[0].any()
    assert pool.session(fast).t == t_frozen
    np.testing.assert_array_equal(pool.session(fast).comm_bytes, bytes_frozen)
    assert pool.session(slow).t == t_frozen + 50
    ref = _session("svrp", prob, dict(grid={"eta": eta, "p": 0.2}, seeds=SEEDS, num_steps=400),
                   rounds=t_frozen)
    _assert_tenant_equal(pool.result(fast), ref)


def test_mixed_horizons_raise_per_tenant(prob, cases):
    pool = SessionPool(capacity=2)
    pool.admit("svrp", prob, device="cpu", **dict(cases["svrp"], num_steps=40))
    short = pool.admit("svrp", prob, device="cpu", **dict(_variant(cases["svrp"]), num_steps=10))
    pool.step(10)
    with pytest.raises(ValueError, match=rf"tenant {short}: .*horizon exhausted"):
        pool.step(1)
    assert pool.session(short).t == 10
    assert pool.freeze_exhausted(1) == 1
    pool.step(30)
    assert pool.session(short).t == 10


def test_unpoolable_tenants_rejected_field_by_field(prob, prob2, cases):
    pool = SessionPool(capacity=4)
    pool.admit("svrp", prob, device="cpu", **cases["svrp"])
    with pytest.raises(ValueError, match=r"(?s)not poolable.*algo"):
        pool.admit("sppm", prob, device="cpu", **cases["sppm"])
    with pytest.raises(ValueError, match=r"(?s)not poolable.*trial count"):
        pool.admit("svrp", prob, grid=cases["svrp"]["grid"], seeds=5, num_steps=12, device="cpu")
    with pytest.raises(ValueError, match=r"(?s)not poolable.*static config"):
        pool.admit("svrp", prob, grid=cases["svrp"]["grid"], seeds=SEEDS, num_steps=12,
                   channel="quant8", device="cpu")
    with pytest.raises(ValueError, match="not poolable"):
        pool.admit("svrp", _quad(2, dim=4), device="cpu", **cases["svrp"])
    pool.admit("svrp", prob2, grid=cases["svrp"]["grid"], seeds=SEEDS, num_steps=77,
               device="cpu")  # another horizon is not a mismatch
    with pytest.raises(ValueError, match="unknown static config"):
        pool.admit("svrp", prob, grid=cases["svrp"]["grid"], seeds=SEEDS, num_steps=12, bogus=1,
                   device="cpu")
    sig = pool_entry_signature("svrp", {"num_steps": 10, "channel": None}, 4, prob,
                               prob.minimizer(), prob.minimizer())
    check_pool_entry(sig, pool_entry_signature("svrp", {"num_steps": 99, "channel": None}, 4,
                                               prob2, prob2.minimizer(), prob2.minimizer()))


def test_pool_admission_errors(prob, cases):
    kw = cases["svrp"]
    pool = SessionPool(capacity=1)
    a = pool.admit("svrp", prob, device="cpu", **kw)
    with pytest.raises(ValueError, match="pool is full"):
        pool.admit("svrp", prob, device="cpu", **_variant(kw))
    with pytest.raises(KeyError, match="unknown tenant id"):
        pool.result(a + 99)
    pool.evict(a)
    with pytest.raises(ValueError, match="already evicted"):
        pool.evict(a)
    with pytest.raises(ValueError, match="no running tenants"):
        pool.step(1)
    with pytest.raises(ValueError, match="capacity"):
        SessionPool(capacity=0)
    with pytest.raises(ValueError, match="batched substrate only"):
        pool.admit(RunSpec("svrp", grid=kw["grid"], seeds=SEEDS, substrate="sequential",
                           static={"num_steps": 12}), prob, device="cpu")


def test_server_pool_mode_multiplexes_tenants(prob, cases):
    kw = cases["svrp"]
    pool = SessionPool(capacity=2)
    a = pool.admit("svrp", prob, device="cpu", **dict(kw, num_steps=20))
    b = pool.admit("svrp", prob, device="cpu", **dict(_variant(kw), num_steps=8))
    srv = FedRoundServer(pool=pool)
    stats = srv.run(30)
    s = stats.summary()
    assert s["rounds"] == 20
    assert pool.session(a).t == 20 and pool.session(b).t == 8
    assert pool.is_frozen(b) and pool.num_running == 0
    assert np.isfinite([s["p50_ms"], s["p95_ms"], s["p99_ms"]]).all()
    assert np.all(np.diff(stats.comm) >= 0) and s["total_comm"] > 0
    assert s["total_comm_bytes"] == s["total_comm"] * pool.wire_bytes_per_vector
    assert s["total_comm"] == sum(int(pool.session(t).comm[:, -1].sum()) for t in (a, b))
    assert s["total_flops"] == pool.total_flops  # per-tick accounting == the ledgers
    _assert_tenant_equal(pool.result(a), _session("svrp", prob, dict(kw, num_steps=20)))
    with pytest.raises(ValueError, match="pool"):
        FedRoundServer("svrp", prob, pool=SessionPool(capacity=1))


def test_pool_matches_reference_pool(cases):
    """Two svrp tenants on distinct problems, a third admitted mid-run, in
    both packages with the reference's draws replayed (each tenant's
    record from its own seeds)."""
    ref_probs = [ref_make_quadratic(num_clients=M, dim=6, mu=1.0, L=80.0, delta=4.0, seed=s)
                 for s in (1, 7, 3)]
    probs = [_quad(s) for s in (1, 7, 3)]
    kws = [cases["svrp"], _variant(cases["svrp"]), dict(cases["svrp"], seeds=[5, 6])]
    ref, pool = RefSessionPool(capacity=3), SessionPool(capacity=3)
    ids = []

    def admit(i):
        rid = ref.admit("svrp", ref_probs[i], **kws[i])
        want = ref.session(rid)
        draws = draws_from_numpy(*replay_draws("svrp", want._seeds, M, {"num_steps": 12},
                                               want._hparams["p"]))
        ids.append((rid, pool.admit("svrp", probs[i], draws=draws, device="cpu", **kws[i])))

    admit(0)
    admit(1)
    ref.step(4)
    pool.step(4)
    admit(2)
    ref.step(8)
    pool.step(8)
    for rid, tid in ids:
        want, got = ref.result(rid), pool.result(tid)
        assert got.comm.numpy().dtype == np.asarray(want.comm).dtype
        np.testing.assert_array_equal(got.comm.numpy(), np.asarray(want.comm))
        np.testing.assert_array_equal(got.comm_bytes, want.comm_bytes)
        np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(want.dist_sq), rtol=1e-5,
                                   atol=1e-24)
    assert pool.total_comm_bytes == ref.total_comm_bytes
    assert pool.total_flops == ref.total_flops
