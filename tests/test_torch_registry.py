"""The port's sequential and registry substrates against `repro`.

The twin of the ROUND_DEFS and ALGOS rows of tests/test_substrates.py: for
every algorithm of `repro`'s ALGOS (composite, whose prox of R and x_star
are each package's own, is held in tests/test_torch_composite.py), on the
same small quadratic (M 10, d 6), the port runs on the CPU with the
reference's own draws replayed from its PRNG keys (tests/_torch_replay.py):

* `run_batch(fused=False)` against `repro`'s `run_batch(fused=False)`, with
  the prox solvers exact, spectral, gd and newton for the rounds-defined
  algorithms and Catalyst;
* `run_sequential` against `repro`'s `run_sequential`, and against the
  port's own `run_batch`;
* the registry path against the fused path for sppm, svrp and minibatch
  with gd;
* deep_svrp on all three substrates (fused, registry, sequential) and
  through `run_deep_svrp`, against the reference's engine and its
  `run_deep_svrp`: comm equal, dist_sq rtol 1e-9 against the same kind of
  run, 1e-6 between a one-trial run and a lane batch (atol 1e-24);
* the Section-4.2 accounting in closed form, and the per-trial drivers.

Tolerances (the reference's own engine tolerances): ``comm``
integer-equal with equal dtype everywhere.  dist_sq and x_final: exact and
gd rtol 1e-6 with an atol floor of 1e-24; spectral and newton, iterative or
eigendecomposed solves, rtol 1e-4 above a 1e-20 floor.  The registry path
against the fused one: rtol 1e-9 (the fused path runs the K1 loop form's
plain version, which rounds in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_replay import draws_from_numpy, replay_draws, replay_trial  # noqa: E402

import repro.core as rcore  # noqa: E402
from repro.core import catalyst_inner_iterations, theorem2_stepsize, theorem3_gamma  # noqa: E402
from repro.experiments import ALGOS as REF_ALGOS  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.experiments import run_sequential as ref_run_sequential  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import Draws, trial_draws  # noqa: E402
from repro_torch.experiments import ALGOS, run_batch, run_sequential  # noqa: E402
from repro_torch.experiments import spec as spec_mod  # noqa: E402
from repro.experiments import spec as ref_spec  # noqa: E402

M = 10
SEEDS = 2
TOL = {"exact": dict(rtol=1e-6, atol=1e-24), "gd": dict(rtol=1e-6, atol=1e-24),
       "spectral": dict(rtol=1e-4, atol=1e-20), "newton": dict(rtol=1e-4, atol=1e-20)}
FUSED_RTOL = 1e-9
ROUND_ALGOS = ["sppm", "svrp", "svrp_minibatch", "catalyzed_svrp"]


@pytest.fixture(scope="module")
def probs():
    q = make_synthetic_quadratic(num_clients=M, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1)
    return q, problem_from_arrays("quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)},
                                  device="cpu")


@pytest.fixture(scope="module")
def cases(probs):
    """tests/test_substrates.py's per-algorithm sweeps (its non-fused column)."""
    q, _ = probs
    mu, delta = float(q.strong_convexity()), float(q.similarity())
    dmax, L = float(q.similarity_max()), float(q.smoothness_max())
    eta = theorem2_stepsize(mu, delta)
    gamma = max(theorem3_gamma(mu, delta, M), 0.5)
    inner = min(catalyst_inner_iterations(mu, delta, M), 40)
    return {
        "sppm": dict(grid={"eta": [0.05, 0.1]}, seeds=SEEDS, num_steps=60),
        "svrp": dict(grid={"eta": [eta, eta / 2], "p": 0.2}, seeds=SEEDS, num_steps=60),
        "svrp_minibatch": dict(grid={"eta": 3 * eta, "p": 0.25}, seeds=SEEDS, num_steps=50,
                               batch_clients=3),
        "catalyzed_svrp": dict(grid={"mu": mu, "gamma": gamma,
                                     "eta": theorem2_stepsize(mu + gamma, delta), "p": 1 / M},
                               seeds=SEEDS, num_outer=3, inner_steps=inner),
        "sgd": dict(grid={"stepsize": 1 / (3 * L)}, seeds=SEEDS, num_steps=80),
        "svrg": dict(grid={"stepsize": 1 / (6 * L), "p": 0.2}, seeds=SEEDS, num_steps=80),
        "scaffold": dict(grid={"local_lr": 1 / (4 * L)}, seeds=SEEDS, num_rounds=40,
                         local_steps=4),
        "dane": dict(grid={"theta": dmax}, num_rounds=15),
        "acc_extragradient": dict(grid={"theta": dmax, "mu": mu}, num_rounds=15),
        "deep_svrp": dict(grid={"eta": [0.05, 0.1], "local_lr": 1 / (2 * L), "anchor_prob": 0.3},
                          seeds=SEEDS, num_steps=40, local_steps=3),
    }


def _with_solver(kw, algo, solver, L):
    """A case's sweep on another registry solver (gd: smoothness, 30 steps)."""
    kw = dict(kw)
    if solver == "exact":
        return kw
    kw["prox_solver"] = solver
    if solver == "gd":
        shift = kw["grid"].get("gamma", 0.0) if algo == "catalyzed_svrp" else 0.0
        kw["grid"] = {**kw["grid"], "smoothness": L + shift}
        kw["prox_steps"] = 30
    return kw


def _draws(algo, ref, kw):
    """The reference sweep's draws, replayed (None for deterministic algos)."""
    if ALGOS[algo].deterministic:
        return None
    cfg = {k: v for k, v in kw.items() if k not in ("grid", "seeds")}
    p = ref.hparams.get("p", ref.hparams.get("anchor_prob"))
    return draws_from_numpy(*replay_draws(algo, ref.seeds, M, cfg, p))


def _check(port, ref, tol):
    ref_comm = np.asarray(ref.comm)
    np.testing.assert_array_equal(port.comm.numpy(), ref_comm)
    assert port.comm.numpy().dtype == ref_comm.dtype
    np.testing.assert_allclose(port.dist_sq.numpy(), np.asarray(ref.dist_sq), **tol)
    np.testing.assert_allclose(port.x_final.numpy(), np.asarray(ref.x_final),
                               rtol=tol["rtol"], atol=1e-12)


# composite's prox of R and x_star are each package's own: test_torch_composite.py
CASE_ALGOS = sorted(set(ALGOS) - {"composite"})
SOLVER_CASES = [(a, "exact") for a in CASE_ALGOS] + [
    (a, s) for s in ("spectral", "gd", "newton") for a in ROUND_ALGOS]


@pytest.fixture(scope="module")
def runs(probs, cases):
    """Every (algo, solver) sweep: the reference's batch and the port's batch
    and per-trial runs on the same draws."""
    q, pq = probs
    L = float(q.smoothness_max())
    out = {}
    for algo, solver in SOLVER_CASES:
        kw = _with_solver(cases[algo], algo, solver, L)
        ref = ref_run_batch(algo, q, **kw)
        draws = _draws(algo, ref, kw)
        port = run_batch(algo, pq, device="cpu", draws=draws, **kw)
        seq = run_sequential(algo, pq, device="cpu", draws=draws, **kw)
        out[algo, solver] = ref, port, seq, kw
    return out


def _plain(table, required):
    return {k: "required" if v is required else v for k, v in table.items()}


def test_every_ported_algo_has_a_case(cases):
    """The port carries every reference ALGOS entry, each with its flags."""
    assert set(cases) == set(CASE_ALGOS)
    assert set(ALGOS) == set(REF_ALGOS)
    for name, spec in ALGOS.items():
        assert spec.deterministic == REF_ALGOS[name].deterministic, name
        for flag in ("fusable", "fused_inner_steps", "fused_round_steps", "requires_x_star"):
            assert getattr(spec, flag) == getattr(REF_ALGOS[name], flag), (name, flag)
        for ours, theirs in ((spec.static, REF_ALGOS[name].static),
                             (spec.defaults, REF_ALGOS[name].defaults)):
            assert _plain(ours, spec_mod._REQUIRED) == _plain(theirs, ref_spec._REQUIRED), name
        assert spec.params_cls._fields == REF_ALGOS[name].params_cls._fields, name


@pytest.mark.parametrize("algo,solver", SOLVER_CASES)
def test_registry_batch_matches_reference(runs, algo, solver):
    ref, port, _, _ = runs[algo, solver]
    _check(port, ref, TOL[solver])
    np.testing.assert_array_equal(port.comm_bytes, ref.comm_bytes)
    assert port.labels() == ref.labels()


@pytest.mark.parametrize("algo", CASE_ALGOS)
def test_sequential_matches_reference(probs, runs, algo):
    q, _ = probs
    ref, _, seq, kw = runs[algo, "exact"]
    _check(seq, ref_run_sequential(algo, q, **kw), TOL["exact"])


@pytest.mark.parametrize("algo,solver", SOLVER_CASES)
def test_sequential_matches_registry_batch(runs, algo, solver):
    """One driver call per trial == the lane batch, trial by trial."""
    _, port, seq, _ = runs[algo, solver]
    np.testing.assert_array_equal(seq.comm.numpy(), port.comm.numpy())
    assert seq.comm.dtype == port.comm.dtype
    np.testing.assert_allclose(seq.dist_sq.numpy(), port.dist_sq.numpy(), **TOL[solver])
    np.testing.assert_array_equal(seq.comm_bytes, port.comm_bytes)


@pytest.mark.parametrize("algo", ["sppm", "svrp", "svrp_minibatch"])
def test_registry_matches_fused_gd(probs, runs, algo):
    """The registry gd solver (the plain per-step loop) and the fused path
    (K1's loop form, plain version here) solve the same Algorithm 7."""
    _, pq = probs
    _, port, _, kw = runs[algo, "gd"]
    ref = runs[algo, "gd"][0]
    fused = run_batch(algo, pq, device="cpu", fused=True, draws=_draws(algo, ref, kw), **kw)
    np.testing.assert_array_equal(fused.comm.numpy(), port.comm.numpy())
    np.testing.assert_allclose(fused.dist_sq.numpy(), port.dist_sq.numpy(), rtol=FUSED_RTOL,
                               atol=0.0)


def test_comm_accounting_closed_form(runs):
    """Per-round increments take exactly the documented values."""
    expected = {
        "sppm": ({2}, {2}),
        "svrp": ({3 * M + 2, 6 * M + 2}, {2, 2 + 3 * M}),
        "svrp_minibatch": ({3 * M + 6, 6 * M + 6}, {6, 6 + 3 * M}),
        "sgd": ({2}, {2}),
        "svrg": ({3 * M + 2, 6 * M + 2}, {2, 2 + 3 * M}),
        "scaffold": ({2}, {2}),
        "dane": ({2 * M + 2}, {2 * M + 2}),
        "acc_extragradient": ({4 * M + 2}, {4 * M + 2}),
        "deep_svrp": ({5 * M, 7 * M}, {2 * M, 4 * M}),
    }
    for algo, (first, incs) in expected.items():
        comm = runs[algo, "exact"][1].comm.numpy()
        assert set(np.unique(comm[:, 0])) <= first, algo
        assert set(np.unique(np.diff(comm, axis=1)).tolist()) <= incs, algo
    # Catalyst's stage boundaries re-pay the 3M anchor setup on the carried offset.
    _, port, _, kw = runs["catalyzed_svrp", "exact"]
    comm = port.comm.numpy()
    inner = kw["inner_steps"]
    assert comm.shape[1] == 3 * inner and comm[0, 0] in (3 * M + 2, 6 * M + 2)
    assert set(np.unique(comm[:, inner] - comm[:, inner - 1])) <= {3 * M + 2, 6 * M + 2}


def test_catalyzed_drivers_agree(probs):
    """`run_catalyzed_svrp` (the lane recurrence) and `run_catalyzed_svrp_host`
    (the host loop over `run_svrp`) against each other and against `repro`'s."""
    q, pq = probs
    mu, delta = float(q.strong_convexity()), float(q.similarity())
    kw = dict(mu=mu, delta=delta, num_outer=3, inner_steps=25)
    cfg = dict(num_outer=3, inner_steps=25)
    ref = rcore.run_catalyzed_svrp(q, jax.numpy.zeros(6), q.minimizer(), key=jax.random.key(3),
                                   **kw)
    ref_host = rcore.run_catalyzed_svrp_host(q, jax.numpy.zeros(6), q.minimizer(),
                                             key=jax.random.key(3), **kw)
    draws = replay_trial("catalyzed_svrp", 3, M, cfg, 1 / M)
    x0, xs = torch.zeros(6, dtype=torch.float64), pq.minimizer()
    port = tcore.run_catalyzed_svrp(pq, x0, xs, draws=draws, device="cpu", **kw)
    host = tcore.run_catalyzed_svrp_host(pq, x0, xs, draws=draws, device="cpu", **kw)
    for got in (port, host):
        for want in (ref, ref_host):
            _check(got, want, TOL["exact"])
    _check(port, host, TOL["exact"])


@pytest.mark.parametrize("algo,solver", [("sppm", "exact"), ("svrp", "gd"),
                                         ("svrp_minibatch", "spectral")])
def test_per_trial_drivers_match_reference(probs, algo, solver):
    q, pq = probs
    mu, delta, L = float(q.strong_convexity()), float(q.similarity()), float(q.smoothness_max())
    kw = {"sppm": dict(eta=0.1, num_steps=40),
          "svrp": dict(eta=theorem2_stepsize(mu, delta), p=0.2, num_steps=40),
          "svrp_minibatch": dict(eta=0.1, p=0.25, batch_clients=3, num_steps=30)}[algo]
    kw.update(prox_solver=solver)
    if solver == "gd":
        kw.update(smoothness=L, prox_steps=30)
    name = f"run_{algo}"
    ref = getattr(rcore, name)(q, jax.numpy.zeros(6), q.minimizer(), key=jax.random.key(5), **kw)
    draws = replay_trial(algo, 5, M, kw, kw.get("p"))
    port = getattr(tcore, name)(pq, torch.zeros(6, dtype=torch.float64), pq.minimizer(),
                                draws=draws, device="cpu", **kw)
    _check(port, ref, TOL[solver])
    if solver == "gd":  # the reference's error text without smoothness
        kw.pop("smoothness")
        with pytest.raises(ValueError) as r:
            getattr(rcore, name)(q, jax.numpy.zeros(6), q.minimizer(), key=jax.random.key(5),
                                 **kw)
        with pytest.raises(ValueError) as t:
            getattr(tcore, name)(pq, torch.zeros(6, dtype=torch.float64), pq.minimizer(),
                                 draws=draws, device="cpu", **kw)
        assert str(t.value) == str(r.value)


@pytest.fixture(scope="module")
def logistic():
    lg = make_a9a_like_problem(num_clients=6, n_per_client=40, n_pool=300, dim=12,
                               nnz_per_row=4, seed=1)
    return lg, problem_from_arrays(
        "logistic", {"Z": np.asarray(lg.Z), "y": np.asarray(lg.y), "lam": lg.lam}, device="cpu")


@pytest.mark.parametrize("algo,solver", [("svrp", "newton"), ("sppm", "newton-cg"),
                                         ("catalyzed_svrp", "exact")])
def test_registry_on_logistic_matches_reference(logistic, algo, solver):
    """Non-quadratic oracles: guarded Newton, Newton-CG and the per-lane
    shifted logistic subproblem of Catalyst."""
    lg, pl = logistic
    kw = {"svrp": dict(grid={"eta": [1.0, 0.5], "p": 0.3}, num_steps=25),
          "sppm": dict(grid={"eta": [0.5, 1.0]}, num_steps=25),
          "catalyzed_svrp": dict(grid={"mu": lg.lam, "gamma": 0.5, "eta": 1.0, "p": 0.3},
                                 num_outer=2, inner_steps=10)}[algo]
    kw.update(seeds=SEEDS, prox_solver=solver)
    ref = ref_run_batch(algo, lg, **kw)
    cfg = {k: v for k, v in kw.items() if k not in ("grid", "seeds")}
    draws = draws_from_numpy(*replay_draws(algo, ref.seeds, lg.num_clients, cfg,
                                           ref.hparams.get("p")))
    x_star = torch.as_tensor(np.array(lg.minimizer()))
    _check(run_batch(algo, pl, device="cpu", draws=draws, x_star=x_star, **kw), ref,
           TOL["newton"])


def test_shifted_lanes_match_shifted(probs):
    """Catalyst's per-lane subproblem, lane by lane, is `QuadraticProblem.shifted`."""
    _, pq = probs
    gen = torch.Generator().manual_seed(0)
    gamma = torch.tensor([0.3, 1.7], dtype=torch.float64)
    y, x, z = (torch.randn(2, 6, generator=gen, dtype=torch.float64) for _ in range(3))
    m = torch.tensor([4, 7])
    eta = torch.tensor([0.2, 0.05], dtype=torch.float64)
    lanes = pq.shifted_lanes(gamma, y)
    factors = pq.prox_factors()
    for s in range(2):
        one = pq.shifted(float(gamma[s]), y[s])
        got = lambda t: t[s]  # noqa: E731
        torch.testing.assert_close(got(lanes.grad(m, x)), one.grad(m[s], x[s]), rtol=1e-14,
                                   atol=1e-14)
        torch.testing.assert_close(got(lanes.full_grad(x)), one.full_grad(x[s]), rtol=1e-14,
                                   atol=1e-14)
        torch.testing.assert_close(got(lanes.prox(m, z, eta)), one.prox(m[s], z[s], eta[s]),
                                   rtol=1e-14, atol=1e-14)
        torch.testing.assert_close(got(lanes.prox_spectral(m, z, eta, factors)),
                                   one.prox(m[s], z[s], eta[s]), rtol=1e-12, atol=1e-12)


def test_trial_draws_shapes_and_checks():
    clients = torch.tensor([1, 2, 3])
    coins = torch.tensor([True, False, True])
    one = trial_draws(Draws(clients, coins, batched=False), None, 5, 3, 0.1)
    assert not one.batched and one.refresh.tolist() == [True, False, True]
    batched = trial_draws(Draws(clients[:, None], coins[:, None]), None, 5, 3, 0.1)
    assert torch.equal(batched.clients, clients) and batched.refresh.tolist() == [1, 0, 1]
    drawn = trial_draws(None, 7, 5, 3, 0.1)
    assert drawn.clients.shape == (3,) and drawn.coins.shape == (3,)
    with pytest.raises(ValueError, match="needs"):
        trial_draws(Draws(clients[:2], coins[:2], batched=False), None, 5, 3, 0.1)
    with pytest.raises(ValueError, match="outside"):
        trial_draws(Draws(clients, coins, batched=False), None, 3, 3, 0.1)
    with pytest.raises(ValueError, match="seed"):
        trial_draws(None, None, 5, 3, 0.1)


@pytest.mark.parametrize("algo,item", [("composite", "item 3"), ("deep_svrp", "item 2")])
def test_unported_algos_raise(probs, algo, item):
    """The two algorithms earlier slices left out (ROADMAP §1 items 2 and 3)
    now run on both entry points and bind their registry ops; the full
    comparisons are test_deep_svrp_substrates_and_entries and
    tests/test_torch_composite.py."""
    from repro_torch.core.composite import prox_l1

    _, pq = probs
    kw = {"deep_svrp": dict(grid={"eta": 0.1, "local_lr": 0.01, "anchor_prob": 0.5}),
          "composite": dict(grid={"eta": 0.1, "p": 0.5, "smoothness": 80.0, "mu": 1.0},
                            prox_R=prox_l1, x_star=pq.minimizer())}[algo]
    comms = []
    for entry in (run_batch, run_sequential):
        res = entry(algo, pq, num_steps=3, device="cpu", **kw)
        assert res.dist_sq.shape == (1, 3) and np.isfinite(res.dist_sq.numpy()).all()
        comms.append(res.comm.numpy())
    np.testing.assert_array_equal(*comms)  # the same native draws
    if algo == "deep_svrp":
        hp = tcore.DeepSVRPScanParams(*(torch.tensor(v, dtype=torch.float64)
                                        for v in (0.1, 0.01, 0.5)))
        draws = Draws(None, torch.tensor([True, False]), batched=False)
        ops = tcore.make_registry_ops("deep_svrp", pq, pq.minimizer(), pq.minimizer(), hp,
                                      draws, local_steps=2)
        assert ops.local_prox_gd is not None and ops.all_clients().tolist() == list(range(M))


@pytest.mark.parametrize("entry", ["engine", "run_deep_svrp"])
@pytest.mark.parametrize("substrate", ["fused", "registry", "sequential"])
def test_deep_svrp_substrates_and_entries(probs, runs, substrate, entry):
    """deep_svrp's one local-solver binding on every substrate, against the
    reference's engine (its run_batch) and its per-trial `run_deep_svrp`."""
    q, pq = probs
    ref, _, _, kw = runs["deep_svrp", "exact"]
    draws = _draws("deep_svrp", ref, kw)
    if substrate == "sequential" and entry == "run_deep_svrp":
        trials = []
        for i, h in enumerate(ref.labels()):
            trials.append(tcore.run_deep_svrp(
                pq, torch.zeros(6, dtype=torch.float64), pq.minimizer(), eta=h["eta"],
                local_lr=h["local_lr"], anchor_prob=h["anchor_prob"], num_steps=kw["num_steps"],
                local_steps=kw["local_steps"], draws=draws.trial(i), device="cpu"))
        got_d2 = np.stack([t.dist_sq.numpy() for t in trials])
        got_comm = np.stack([t.comm.numpy() for t in trials])
    else:
        entry_fn = run_sequential if substrate == "sequential" else run_batch
        extra = {"fused": True} if substrate == "fused" else {}
        got = entry_fn("deep_svrp", pq, device="cpu", draws=draws, **extra, **kw)
        got_d2, got_comm = got.dist_sq.numpy(), got.comm.numpy()
        assert got.comm.dtype == torch.int32
    if entry == "engine":
        want = ref
    else:
        want_trials = [rcore.run_deep_svrp(q, jax.numpy.zeros(6), q.minimizer(), eta=h["eta"],
                                           local_lr=h["local_lr"], anchor_prob=h["anchor_prob"],
                                           num_steps=kw["num_steps"],
                                           local_steps=kw["local_steps"],
                                           key=jax.random.key(int(s)))
                       for h, s in zip(ref.labels(), ref.seeds)]
        want = tcore.RunResult(np.stack([np.asarray(t.dist_sq) for t in want_trials]),
                               np.stack([np.asarray(t.comm) for t in want_trials]), None)
    np.testing.assert_array_equal(got_comm, np.asarray(want.comm))
    same_kind = (substrate == "sequential") == (entry == "run_deep_svrp")
    tol = dict(rtol=1e-9, atol=1e-24) if same_kind else TOL["exact"]
    np.testing.assert_allclose(got_d2, np.asarray(want.dist_sq), **tol)
    assert (got_d2[:, -1] < 1e-3 * got_d2[:, 0]).all()


def test_a_stale_refresh_fails_the_check(probs, runs, monkeypatch):
    """A planted fault, the refresh keeping the stale anchor gradient, moves
    the trajectory beyond the tolerance the comparison above holds."""
    from repro_torch.core import rounds

    _, pq = probs
    ref, _, _, kw = runs["svrp", "exact"]
    draws = _draws("svrp", ref, kw)
    assert draws.refresh.any()
    monkeypatch.setattr(rounds.RoundOps, "refresh_grad", lambda self, k, c, w, gbar: gbar)
    stale = run_batch("svrp", pq, device="cpu", draws=draws, **kw)
    np.testing.assert_array_equal(stale.comm.numpy(), np.asarray(ref.comm))
    with pytest.raises(AssertionError):
        _check(stale, ref, TOL["exact"])
