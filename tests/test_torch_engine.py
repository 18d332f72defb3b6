"""The port's engine (`repro_torch.experiments.run_batch(fused=True)`) against `repro`.

For sppm, svrp, svrp_minibatch and catalyzed_svrp, on the quadratic and the
logistic problem, the port runs on the CPU (plain kernel versions) with the
reference's own draws replayed from its PRNG keys (tests/_torch_replay.py),
and the reference runs `run_batch(fused=True, interpret=True)` (its Pallas
kernels in interpret mode).  The contract is tests/test_substrates.py's:
dist_sq rtol 1e-5 / atol 1e-24, x_final atol 1e-12, comm integer-equal with
equal dtype, comm_bytes equal, labels equal.  Validation errors carry the
reference's texts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_replay import draws_from_numpy, replay_draws  # noqa: E402

from repro.core import theorem2_stepsize  # noqa: E402
from repro.experiments import RunSpec as RefRunSpec  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.experiments import RunSpec, run_batch, run_sequential  # noqa: E402

GD = {"prox_solver": "gd", "prox_steps": 20}


@pytest.fixture(scope="module")
def problems():
    q = make_synthetic_quadratic(num_clients=10, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1)
    lg = make_a9a_like_problem(num_clients=6, n_per_client=40, n_pool=300, dim=12,
                               nnz_per_row=4, seed=1)
    return {
        "quadratic": (q, problem_from_arrays(
            "quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)}, device="cpu")),
        "logistic": (lg, problem_from_arrays(
            "logistic", {"Z": np.asarray(lg.Z), "y": np.asarray(lg.y), "lam": lg.lam},
            device="cpu")),
    }


def _case(algo, ref_p):
    """tests/test_substrates.py's fused configs, with problem-specific stepsizes."""
    L = float(ref_p.smoothness_max())
    if hasattr(ref_p, "A"):
        mu, delta = float(ref_p.strong_convexity()), float(ref_p.similarity())
        eta = theorem2_stepsize(mu, delta)
    else:  # logistic: lambda-strongly convex, stepsizes in the Theorem-2 range
        mu, eta = float(ref_p.lam), 1.0
    return {
        "sppm": dict(grid={"eta": [0.05, 0.1], "smoothness": L}, seeds=2, num_steps=60),
        "svrp": dict(grid={"eta": [eta, eta / 2], "p": 0.2, "smoothness": L}, seeds=2,
                     num_steps=60),
        "svrp_minibatch": dict(grid={"eta": 3 * eta, "p": 0.25, "smoothness": L}, seeds=2,
                               num_steps=50, batch_clients=3),
        "catalyzed_svrp": dict(grid={"mu": mu, "gamma": 0.5, "eta": eta, "p": 0.1,
                                     "smoothness": L}, seeds=2, num_outer=3, inner_steps=20),
    }[algo]


def _check(ref, port):
    np.testing.assert_allclose(port.dist_sq.numpy(), np.asarray(ref.dist_sq), rtol=1e-5,
                               atol=1e-24)
    np.testing.assert_array_equal(port.comm.numpy(), np.asarray(ref.comm))
    assert port.comm.numpy().dtype == np.asarray(ref.comm).dtype
    np.testing.assert_array_equal(port.comm_bytes, ref.comm_bytes)
    assert port.comm_bytes.dtype == np.int64
    np.testing.assert_allclose(port.x_final.numpy(), np.asarray(ref.x_final), rtol=1e-5,
                               atol=1e-12)
    assert port.labels() == ref.labels()


ALGOS = ["sppm", "svrp", "svrp_minibatch", "catalyzed_svrp"]


@pytest.fixture(scope="module")
def runs(problems):
    """Every (algo, problem) sweep through both packages, run once."""
    out = {}
    for kind, (ref_p, port_p) in problems.items():
        for algo in ALGOS:
            kw = _case(algo, ref_p)
            ref = ref_run_batch(algo, ref_p, fused=True, interpret=True, **kw, **GD)
            cfg = {k: v for k, v in kw.items() if k not in ("grid", "seeds")}
            clients, coins = replay_draws(algo, ref.seeds, ref_p.num_clients, cfg,
                                          ref.hparams.get("p"))
            port = run_batch(algo, port_p, fused=True, device="cpu",
                             draws=draws_from_numpy(clients, coins), **kw, **GD)
            out[algo, kind] = ref, port
    return out


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_sweep_matches_reference(runs, algo, kind):
    _check(*runs[algo, kind])


@pytest.mark.parametrize("kind", ["quadratic", "logistic"])
def test_batch_result_summaries_match(runs, kind):
    ref, port = runs["svrp", kind]
    eps = float(np.median(np.asarray(ref.dist_sq)[:, 30]))
    np.testing.assert_array_equal(port.comm_to_accuracy(eps), ref.comm_to_accuracy(eps))
    np.testing.assert_array_equal(port.bytes_to_accuracy(eps), ref.bytes_to_accuracy(eps))
    budget = int(np.asarray(ref.comm)[0, 40])
    np.testing.assert_allclose(port.final_at_budget(budget), ref.final_at_budget(budget),
                               rtol=1e-5)
    for key, val in ref.summary().items():
        np.testing.assert_allclose(port.summary()[key], val, rtol=1e-5, atol=1e-24)
    t_ref, t_port = ref.trial(1), port.trial(1)
    np.testing.assert_array_equal(t_port.comm.numpy(), np.asarray(t_ref.comm))
    assert float(t_port.comm_to_accuracy(eps)) == float(t_ref.comm_to_accuracy(eps))


def test_runspec_matches_keyword_style(problems, runs):
    """`run_batch(RunSpec(...))` resolves through the same path as keywords."""
    ref, port = runs["svrp", "quadratic"]
    _, port_p = problems["quadratic"]
    kw = _case("svrp", problems["quadratic"][0])
    spec = RunSpec("svrp", grid=kw["grid"], seeds=kw["seeds"],
                   static={"num_steps": kw["num_steps"], **GD})
    cfg = {"num_steps": kw["num_steps"]}
    clients, coins = replay_draws("svrp", ref.seeds, 10, cfg, ref.hparams["p"])
    again = run_batch(spec, port_p, fused=True, device="cpu",
                      draws=draws_from_numpy(clients, coins))
    np.testing.assert_array_equal(again.dist_sq.numpy(), port.dist_sq.numpy())


# ------------------------------------------------------------ validation texts
VALIDATION_CASES = {
    "unknown_hparam": dict(algo="svrp", grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0, "bogus": 1},
                           num_steps=5, **GD),
    "missing_hparam": dict(algo="svrp", grid={"eta": 0.1, "smoothness": 1.0}, num_steps=5, **GD),
    "unknown_static": dict(algo="sppm", grid={"eta": 0.1, "smoothness": 1.0}, num_steps=5,
                           warp=3, **GD),
    "missing_static": dict(algo="svrp_minibatch", grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0},
                           num_steps=5, **GD),
    "gd_without_smoothness": dict(algo="svrp", grid={"eta": 0.1, "p": 0.1}, num_steps=5, **GD),
    "unknown_stepsize_mode": dict(algo="svrp", grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0},
                                  stepsize="magic", num_steps=5, **GD),
    "unknown_prox_solver": dict(algo="svrp", grid={"eta": 0.1, "p": 0.1}, num_steps=5,
                                prox_solver="bogus"),
    "not_gd_fused": dict(algo="svrp", grid={"eta": 0.1, "p": 0.1}, num_steps=5,
                         prox_solver="exact"),
    "unknown_channel": dict(algo="svrp", grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0},
                            num_steps=5, channel="carrier-pigeon", **GD),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_error_texts_match(problems, case):
    kw = dict(VALIDATION_CASES[case])
    algo = kw.pop("algo")
    ref_p, port_p = problems["quadratic"]
    with pytest.raises(ValueError) as r:
        ref_run_batch(algo, ref_p, fused=True, **kw)
    with pytest.raises(ValueError) as t:
        run_batch(algo, port_p, fused=True, device="cpu", **kw)
    assert str(t.value) == str(r.value)


def test_spectral_on_logistic_error_text_matches(problems):
    ref_p, port_p = problems["logistic"]
    kw = dict(grid={"eta": 0.1, "p": 0.1}, num_steps=5, prox_solver="spectral")
    with pytest.raises(ValueError) as r:
        ref_run_batch("svrp", ref_p, fused=True, **kw)
    with pytest.raises(ValueError) as t:
        run_batch("svrp", port_p, fused=True, device="cpu", **kw)
    assert str(t.value) == str(r.value)


def test_runspec_clash_error_text_matches(problems):
    ref_p, port_p = problems["quadratic"]
    with pytest.raises(ValueError) as r:
        ref_run_batch(RefRunSpec("svrp", grid={"eta": 0.1, "p": 0.1}), ref_p, seeds=3,
                      num_steps=4)
    with pytest.raises(ValueError) as t:
        run_batch(RunSpec("svrp", grid={"eta": 0.1, "p": 0.1}), port_p, seeds=3, num_steps=4,
                  fused=True, device="cpu")
    assert str(t.value) == str(r.value)


def test_unknown_substrate_error_text_matches(problems):
    ref_p, port_p = problems["quadratic"]
    spec = dict(grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0}, substrate="warp",
                static={"num_steps": 4, **GD})
    with pytest.raises(ValueError) as r:
        ref_run_batch(RefRunSpec("svrp", **spec), ref_p, fused=True)
    with pytest.raises(ValueError) as t:
        run_batch(RunSpec("svrp", **spec), port_p, fused=True, device="cpu")
    assert str(t.value) == str(r.value)


@pytest.mark.parametrize("what", ["fused_false", "shard", "stop_eps", "theory", "sequential",
                                  "quant8", "clients"])
def test_unported_paths_raise(problems, what):
    """The paths the first slice left out, each ported since: the registry
    substrate ``fused=False``, ``stepsize="theory"``, `run_sequential`, the
    quant8 channel and ``stop_eps=`` (which runs on the session substrate
    and equals `open_session(...).run_until`) return a sweep of the expected
    shape that agrees with the fused one's comm (quant8: and prices each
    vector at d int8 bytes plus one float32 scale a 256-value block);
    ``shard="data"`` in a world of one equals the fused sweep bit for bit,
    and the ``"clients"`` session substrate equals ``run_batch(shard=
    "clients")`` bit for bit and the unsharded sweep to the reference's
    rtol 1e-5 with comm equal."""
    _, port_p = problems["quadratic"]
    kw = dict(grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0}, num_steps=4, device="cpu", **GD)
    if what == "quant8":
        kw["grid"] = {"eta": 0.1, "p": 0.1, "smoothness": float(port_p.smoothness_max())}
        fused = run_batch("svrp", port_p, fused=True, **kw)
        res = run_batch("svrp", port_p, fused=True, channel="quant8", **kw)
        np.testing.assert_array_equal(res.comm.numpy(), fused.comm.numpy())
        d = port_p.dim
        np.testing.assert_array_equal(res.comm_bytes, fused.comm_bytes // (8 * d) * (d + 4))
        assert res.dist_sq.shape == (1, 4) and np.isfinite(res.dist_sq.numpy()).all()
        return
    if what == "shard":
        fused = run_batch("svrp", port_p, fused=True, **kw)
        res = run_batch("svrp", port_p, fused=True, shard="data", **kw)
        for field in ("dist_sq", "comm", "x_final"):
            assert torch.equal(getattr(res, field), getattr(fused, field)), field
        return
    if what in ("stop_eps", "clients"):
        from repro_torch.serve import open_session

        kw = {k: v for k, v in kw.items() if k not in GD}
        if what == "clients":
            sess = open_session("svrp", port_p, substrate="clients", **kw)
            sess.step(1)
            sess.step(3)
            res = sess.result()
            want = run_batch("svrp", port_p, shard="clients", **kw)
            for field in ("dist_sq", "comm", "x_final"):
                assert torch.equal(getattr(res, field), getattr(want, field)), field
            plain = run_batch("svrp", port_p, **kw)
            np.testing.assert_array_equal(res.comm.numpy(), plain.comm.numpy())
            np.testing.assert_allclose(res.dist_sq.numpy(), plain.dist_sq.numpy(), rtol=1e-5)
            return
        res = run_batch("svrp", port_p, stop_eps=1e-6, **kw)
        want = open_session("svrp", port_p, **kw).run_until(1e-6)
        assert torch.equal(res.dist_sq, want.dist_sq) and torch.equal(res.comm, want.comm)
        np.testing.assert_array_equal(res.stopped_round, want.stopped_round)
        assert res.dist_sq.shape[0] == 1 and 1 <= res.dist_sq.shape[1] <= 4
        return
    fused = run_batch("svrp", port_p, fused=True, **kw)
    if what == "theory":
        kw["grid"] = {"smoothness": 1.0}
        res = run_batch("svrp", port_p, fused=True, stepsize="theory", **kw)
        assert set(res.hparams) == {"eta", "p", "smoothness"}
    else:
        entry = run_sequential if what == "sequential" else run_batch
        res = entry("svrp", port_p, **kw)
        np.testing.assert_array_equal(res.comm.numpy(), fused.comm.numpy())
    assert res.dist_sq.shape == (1, 4) and np.isfinite(res.dist_sq.numpy()).all()


def test_injected_draws_of_wrong_shape_raise(problems):
    _, port_p = problems["quadratic"]
    clients = np.zeros((3, 2), dtype=np.int64)
    with pytest.raises(ValueError, match="injected draws"):
        run_batch("svrp", port_p, grid={"eta": 0.1, "p": 0.1, "smoothness": 1.0}, seeds=2,
                  num_steps=4, fused=True, device="cpu",
                  draws=draws_from_numpy(clients, clients.astype(bool)), **GD)


def test_native_draws_run_and_converge(problems):
    """Without injected draws the sweep draws natively from the trial seeds."""
    ref_p, port_p = problems["quadratic"]
    kw = _case("svrp", ref_p)
    a = run_batch("svrp", port_p, fused=True, device="cpu", **kw, **GD)
    b = run_batch("svrp", port_p, fused=True, device="cpu", **kw, **GD)
    np.testing.assert_array_equal(a.dist_sq.numpy(), b.dist_sq.numpy())
    d2 = a.dist_sq.numpy()
    assert np.isfinite(d2).all() and np.median(d2[:, -1]) < np.median(d2[:, 0])


@pytest.mark.parametrize("name,args", [
    ("theorem1_iterations", (2.0, 1.0, 1e-6, 3.0)),
    ("theorem1_stepsize", (2.0, 1.0, 1e-6)),
    ("theorem1_prox_accuracy", (0.3, 1.0, 1e-6)),
    ("theorem2_stepsize", (1.0, 10.0)),
    ("theorem2_rate", (1.0, 10.0, 1000)),
    ("theorem2_iterations", (1.0, 10.0, 1000, 1e-10, 4e-5)),
    ("theorem3_gamma", (1.0, 10.0, 1000)),
    ("theorem3_gamma", (0.1, 40.0, 100)),
    ("catalyst_inner_iterations", (1.0, 10.0, 1000)),
])
def test_theorem_helpers_match(name, args):
    import repro.core as rcore
    import repro_torch.core as tcore

    assert getattr(tcore, name)(*args) == getattr(rcore, name)(*args)


def test_catalyst_extrapolate_matches():
    import jax.numpy as jnp

    from repro.core.catalyst import catalyst_extrapolate as ref_ex
    from repro_torch.core import catalyst_extrapolate

    alpha, q = np.array([0.3, 0.9, 1.0]), np.array([0.01, 0.5, 1.0])
    want = ref_ex(jnp.asarray(alpha), jnp.asarray(q))
    got = catalyst_extrapolate(torch.as_tensor(alpha), torch.as_tensor(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)


def test_hparams_from_numpy(problems):
    from repro_torch.convert import hparams_from_numpy

    hp = hparams_from_numpy("svrp", {"eta": np.array([0.1, 0.2]), "p": np.array([0.5, 0.5]),
                                     "smoothness": np.array([3.0, 3.0])}, device="cpu")
    assert type(hp).__name__ == "SVRPParams" and hp.eta.dtype == torch.float64
    np.testing.assert_array_equal(hp.p.numpy(), [0.5, 0.5])
    with pytest.raises(ValueError, match="need fields"):
        hparams_from_numpy("svrp", {"eta": np.array([0.1])}, device="cpu")
