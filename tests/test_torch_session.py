"""The port's incremental sessions (`repro_torch.serve.open_session`) against
its own `run_batch` and against `repro.serve.open_session`.

The twin of tests/test_session.py, on the same small quadratic (M 10, d 6)
and case table:

* for every `ALGOS` entry, on both session substrates, rounds stepped in
  uneven chunks (1, H // 3, the rest) equal `run_batch` / `run_sequential`
  over the same record BIT FOR BIT (dist_sq, comm and its dtype, x), and a
  step past the horizon raises;
* for every `ALGOS` entry, the session with the reference's draws replayed
  from its keys (tests/_torch_replay.py) equals the reference's session:
  comm integer-equal with equal dtype, comm_bytes and the FLOPs ledger
  equal, dist_sq to the registry tolerances of tests/test_torch_registry.py
  (rtol 1e-6 above a 1e-24 floor; composite, whose prox of R is each
  package's own, above a 1e-20 floor);
* `run_batch(stop_eps=...)` stops at the reference's rounds with its bytes,
  a prefix of the full run; a trial that never reaches eps runs the whole
  horizon; the error texts of the three entry points agree;
* DeepSVRP on the federated LM at the reduced sizes of
  tests/test_torch_fed_lm.py: a session stepped 1 + 2 rounds equals
  `run_batch` bit for bit, and its FLOPs ledger the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_replay import draws_from_numpy, replay_draws  # noqa: E402

from repro.core import catalyst_inner_iterations, theorem2_stepsize, theorem3_gamma  # noqa: E402
from repro.core import composite as rcomp  # noqa: E402
from repro.core.flops import ledger_flops as ref_ledger_flops  # noqa: E402
from repro.experiments import RunSpec as RefRunSpec  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.problems import make_synthetic_quadratic  # noqa: E402
from repro.serve import open_session as ref_open_session  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import composite as tcomp  # noqa: E402
from repro_torch.experiments import ALGOS, RunSpec, run_batch, run_sequential  # noqa: E402
from repro_torch.serve import open_session  # noqa: E402

M = 10
SEEDS = 2
TOL = dict(rtol=1e-6, atol=1e-24)
COMPOSITE_TOL = dict(rtol=1e-6, atol=1e-20)
SUBSTRATES = ("sequential", "batched")
L2_RADIUS = 0.1


@pytest.fixture(scope="module")
def probs():
    q = make_synthetic_quadratic(num_clients=M, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1)
    return q, problem_from_arrays("quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)},
                                  device="cpu")


@pytest.fixture(scope="module")
def cases(probs):
    """tests/test_session.py's per-algorithm sweeps, as (reference, port)
    keyword pairs (composite's prox of R is each package's own; its x_star
    the reference's, handed to both)."""
    q, _ = probs
    mu, delta = float(q.strong_convexity()), float(q.similarity())
    dmax, L = float(q.similarity_max()), float(q.smoothness_max())
    eta = theorem2_stepsize(mu, delta)
    gamma = max(theorem3_gamma(mu, delta, M), 0.5)
    inner = min(catalyst_inner_iterations(mu, delta, M), 12)
    x_star_c = np.array(rcomp.composite_minimizer_pgd(
        q, rcomp.prox_l2ball(L2_RADIUS), L=float(q.smoothness()), num_steps=3000))
    shared = {
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
                          seeds=SEEDS, num_steps=12),
    }
    out = {algo: (dict(kw), dict(kw)) for algo, kw in shared.items()}
    out["composite"][0].update(prox_R=rcomp.prox_l2ball(L2_RADIUS), x_star=jnp.asarray(x_star_c))
    out["composite"][1].update(prox_R=tcomp.prox_l2ball(L2_RADIUS),
                               x_star=torch.as_tensor(x_star_c))
    return out


def _replayed(algo, ref_res, kw):
    """The reference sweep's draws, replayed (None for deterministic algos)."""
    if ALGOS[algo].deterministic:
        return None
    cfg = {k: v for k, v in kw.items() if k not in ("grid", "seeds", "prox_R", "x_star")}
    p = ref_res.hparams.get("p", ref_res.hparams.get("anchor_prob"))
    return draws_from_numpy(*replay_draws(algo, ref_res.seeds, M, cfg, p))


def test_every_algo_has_a_case(cases):
    assert set(cases) == set(ALGOS)


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_session_matches_run_batch_bit_for_bit(algo, substrate, probs, cases):
    """k rounds stepped in uneven chunks are the first k columns of the
    engine's run over the same (natively drawn) record, bit for bit."""
    _, pq = probs
    kw = cases[algo][1]
    entry = run_batch if substrate == "batched" else run_sequential
    ref = entry(algo, pq, device="cpu", **kw)
    sess = open_session(algo, pq, substrate=substrate, device="cpu", **kw)
    H = sess.horizon
    assert ref.dist_sq.shape == (sess.num_trials, H)
    d2a, comm_a = sess.step(1)
    assert d2a.shape == (sess.num_trials, 1)
    sess.step(H // 3)
    sess.step(H - 1 - H // 3)
    assert sess.t == H
    assert torch.equal(sess.dist_sq, ref.dist_sq)
    assert torch.equal(sess.comm, ref.comm) and sess.comm.dtype == ref.comm.dtype
    assert torch.equal(comm_a, ref.comm[:, :1])
    assert torch.equal(sess.x(), ref.x_final)
    res = sess.result()
    np.testing.assert_array_equal(res.comm_bytes, ref.comm_bytes)
    assert res.labels() == ref.labels() and res.stopped_round is None
    with pytest.raises(ValueError, match="horizon exhausted"):
        sess.step()


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_session_matches_reference_session(algo, probs, cases):
    """The same sweep as a session in both packages, the reference's draws
    replayed: comm exact, bytes and FLOPs ledgers equal, dist_sq to tolerance."""
    q, pq = probs
    rkw, tkw = cases[algo]
    ref = ref_open_session(algo, q, **rkw)
    H = ref.horizon
    ref.step(H)  # one chunk (one compilation); the port's side steps in two
    want = ref.result()
    sess = open_session(algo, pq, device="cpu", draws=_replayed(algo, want, tkw), **tkw)
    assert sess.horizon == H
    k1 = max(1, H // 3)
    sess.step(H - k1)
    sess.step(k1)
    got = sess.result()
    ref_comm = np.asarray(want.comm)
    np.testing.assert_array_equal(got.comm.numpy(), ref_comm)
    assert got.comm.numpy().dtype == ref_comm.dtype
    np.testing.assert_array_equal(got.comm_bytes, want.comm_bytes)
    np.testing.assert_array_equal(sess.flops, ref.flops)
    tol = COMPOSITE_TOL if algo == "composite" else TOL
    np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(want.dist_sq), **tol)
    np.testing.assert_allclose(got.x_final.numpy(), np.asarray(want.x_final), rtol=tol["rtol"],
                               atol=1e-12)
    assert got.labels() == want.labels()


def test_session_prefix_is_stable(probs, cases):
    """Stepping one round at a time equals stepping the horizon at once."""
    _, pq = probs
    kw = cases["svrp"][1]
    a = open_session("svrp", pq, device="cpu", **kw)
    b = open_session("svrp", pq, device="cpu", **kw)
    for _ in range(a.horizon):
        a.step(1)
    b.step(b.horizon)
    assert torch.equal(a.dist_sq, b.dist_sq) and torch.equal(a.comm, b.comm)


def test_stop_eps_matches_reference(probs):
    """run_batch(stop_eps=...) on the session substrate: the reference's
    stopped rounds and bytes, each the first crossing, a prefix of the full run."""
    q, pq = probs
    eta = theorem2_stepsize(1.0, float(q.similarity()))
    kw = dict(grid={"eta": eta, "p": 0.2}, seeds=3, num_steps=200)
    eps = 1e-10
    want = ref_run_batch("svrp", q, stop_eps=eps, **kw)
    draws = _replayed("svrp", want, kw)
    full = run_batch("svrp", pq, device="cpu", draws=draws, **kw)
    got = run_batch("svrp", pq, device="cpu", draws=draws, stop_eps=eps, **kw)
    k = got.dist_sq.shape[1]
    assert 0 < k < 200 and k == want.dist_sq.shape[1]
    np.testing.assert_array_equal(got.stopped_round, want.stopped_round)
    np.testing.assert_array_equal(got.comm_bytes, want.comm_bytes)
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(want.comm))
    assert torch.equal(got.dist_sq, full.dist_sq[:, :k])
    d2 = full.dist_sq.numpy()
    first = np.argmax(d2 <= eps, axis=1) + 1
    np.testing.assert_array_equal(got.stopped_round, first)
    assert full.stopped_round is None


def test_stop_eps_never_hit_runs_full_horizon(probs):
    _, pq = probs
    res = run_batch("sppm", pq, grid={"eta": 0.05}, seeds=2, num_steps=10, stop_eps=1e-30,
                    device="cpu")
    assert res.dist_sq.shape[1] == 10
    np.testing.assert_array_equal(res.stopped_round, [-1, -1])


@pytest.mark.parametrize("extra", [dict(fused=True), dict(shard="data")])
def test_stop_eps_rejects_fused_and_shard(probs, extra):
    _, pq = probs
    kw = dict(grid={"eta": 0.1, "p": 0.2, "smoothness": 80.0}, num_steps=10,
              prox_solver="gd")
    with pytest.raises(ValueError, match="stop_eps"):
        run_batch("svrp", pq, stop_eps=1e-8, device="cpu", **extra, **kw)


def _error_text(fn):
    with pytest.raises((ValueError, KeyError)) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("bad_call", ["unknown_static", "bad_substrate", "spec_kwarg_clash",
                                      "unknown_algo", "unknown_hparam"])
def test_identical_error_text_across_entry_points(bad_call, probs):
    """The port's three entry points share one resolution path: every
    validation failure gives the reference's run_batch text."""
    q, pq = probs
    good = dict(grid={"eta": 0.1, "p": 0.2}, num_steps=10)

    def calls(spec_cls, prob, entry):
        return {
            "unknown_static": lambda: entry("svrp", prob, grid=good["grid"], num_steps=10,
                                            bogus=1),
            "bad_substrate": lambda: entry(spec_cls("svrp", grid=good["grid"], substrate="turbo",
                                                    static={"num_steps": 10}), prob),
            "spec_kwarg_clash": lambda: entry(spec_cls("svrp", grid=good["grid"],
                                                       static={"num_steps": 10}),
                                              prob, grid={"eta": 0.2}),
            "unknown_algo": lambda: entry("svrq", prob, **good),
            "unknown_hparam": lambda: entry("svrp", prob, grid={"eta": 0.1, "p": 0.2, "zeta": 1},
                                            num_steps=10),
        }[bad_call]

    def cpu(fn):
        return lambda *a, **k: fn(*a, device="cpu", **k)

    texts = [_error_text(calls(RunSpec, pq, cpu(entry)))
             for entry in (run_batch, run_sequential, open_session)]
    assert texts[0] == texts[1] == texts[2]
    assert texts[0] == _error_text(calls(RefRunSpec, q, ref_run_batch))


def test_runspec_and_clients_substrate(probs, cases):
    """A RunSpec's substrate picks the session's; "clients" (in a world of
    one) equals ``run_batch(shard="clients")`` bit for bit."""
    _, pq = probs
    kw = cases["svrp"][1]
    spec = RunSpec("svrp", grid=kw["grid"], seeds=SEEDS, substrate="sequential",
                   static={"num_steps": 12})
    sess = open_session(spec, pq, device="cpu")
    assert sess.substrate == "sequential"
    sess.step(12)
    rb = run_batch(dataclasses.replace(spec, substrate=None), pq, device="cpu")
    assert torch.equal(sess.comm, rb.comm)
    clients = open_session(dataclasses.replace(spec, substrate="clients"), pq, device="cpu")
    assert clients.substrate == "clients"
    clients.step(5)
    clients.step(7)
    want = run_batch(dataclasses.replace(spec, substrate=None), pq, shard="clients", device="cpu")
    for field in ("dist_sq", "comm", "x_final"):
        assert torch.equal(getattr(clients.result(), field), getattr(want, field)), field


# ------------------------------------------------------------ the federated LM
def _lm_cfg(registry):
    """fed_transformer.py's cpu-small preset (tests/test_torch_fed_lm.py)."""
    d, L, h, kv, ff, vocab = 64, 2, 4, 2, 128, 128
    return dataclasses.replace(
        registry["llama3.2-3b"].reduced(), num_layers=L, d_model=d, num_heads=h,
        num_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab_size=vocab,
        param_dtype="float32", compute_dtype="float32")


def test_deep_svrp_session_on_fed_lm():
    """DeepSVRP on the federated LM through the registry binding (K1 a local
    step, K4 / K4b a client gradient; their plain versions here): a session
    stepped 1 + 2 rounds equals run_batch bit for bit, and its FLOPs ledger
    equals the reference's on the reference's problem."""
    from repro.configs import REGISTRY as JREG
    from repro.problems import make_fed_lm_problem as ref_make_fed_lm
    from repro_torch.configs import REGISTRY
    from repro_torch.problems.fed_lm import make_fed_lm_problem

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prob, x0 = make_fed_lm_problem(_lm_cfg(REGISTRY), num_clients=3, per_client_batch=2,
                                       seq_len=16, alpha=0.3, seed=0, device="cpu")
        kw = dict(grid={"eta": 1.0, "local_lr": 0.2, "anchor_prob": 0.5}, seeds=[1, 2], x0=x0,
                  x_star=x0, num_steps=3, local_steps=2)
        full = run_batch("deep_svrp", prob, device="cpu", **kw)
        sess = open_session("deep_svrp", prob, device="cpu", **kw)
        sess.step(1)
        sess.step(2)
    finally:
        torch.set_num_threads(n)
    assert torch.equal(sess.dist_sq, full.dist_sq)
    assert torch.equal(sess.comm, full.comm) and sess.comm.dtype == torch.int32
    assert torch.equal(sess.x(), full.x_final)
    jprob, _ = ref_make_fed_lm(_lm_cfg(JREG), num_clients=3, per_client_batch=2, seq_len=16,
                               alpha=0.3, seed=0)
    want = ref_ledger_flops("deep_svrp", {"num_steps": 3, "local_steps": 2, "channel": None},
                            jprob, sess.comm.numpy())
    assert want.shape == (2, 3)
    np.testing.assert_array_equal(sess.flops, want)
