"""The port's streaming round server (`repro_torch.serve.FedRoundServer`,
`ClientStream`) against `repro.serve`'s.

* `ClientStream`'s residency masks equal the reference's bit for bit (the
  same numpy code and seed).
* Under the reference's masked draws replayed — per round t, from
  ``fold_in(key(seed), t)``: a masked categorical for the one sampled
  client, a masked Gumbel top-k for a minibatch cohort, the refresh coin at
  the iterate's dtype (computed here with jax over the same masks) — the
  port's server equals the reference's over 20 rounds for sppm, svrp,
  svrp_minibatch and deep_svrp on the quadratic: comm exact, comm_bytes and
  the FLOPs column exact, dist_sq to rtol 1e-6 above a 1e-24 floor (the
  registry tolerance of tests/test_torch_registry.py).
* Native draws (the server's own generator) touch only the clients resident
  when each round starts; cohorts have no repeats; a replayed pick that is
  not resident is refused.
* The reference's refusals: non-rounds algorithms, missing hparams,
  minibatch cohorts under a stream whose ``min_resident < batch_clients``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import theorem2_stepsize  # noqa: E402
from repro.problems import make_synthetic_quadratic  # noqa: E402
from repro.serve import ClientStream as RefClientStream  # noqa: E402
from repro.serve import FedRoundServer as RefFedRoundServer  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import Draws  # noqa: E402
from repro_torch.serve import ClientStream, FedRoundServer  # noqa: E402

M = 10
ROUNDS = 20
TOL = dict(rtol=1e-6, atol=1e-24)


@pytest.fixture(scope="module")
def probs():
    q = make_synthetic_quadratic(num_clients=M, dim=6, mu=1.0, L=80.0, delta=4.0, seed=1)
    return q, problem_from_arrays("quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)},
                                  device="cpu")


def _cases(q):
    eta = theorem2_stepsize(1.0, float(q.similarity()))
    L = float(q.smoothness_max())
    return {
        "sppm": dict(hparams={"eta": 0.05}),
        "svrp": dict(hparams={"eta": eta, "p": 0.2}),
        "svrp_minibatch": dict(hparams={"eta": 3 * eta, "p": 0.25}, batch_clients=3),
        "deep_svrp": dict(hparams={"eta": 0.5, "local_lr": 0.8 / (L + 2.0), "anchor_prob": 0.25},
                          local_steps=3),
    }


STREAM = dict(churn=0.3, min_resident=4)


def _masks(seed, rounds):
    stream = RefClientStream(M, seed=seed, **STREAM)
    return [stream.tick() for _ in range(rounds)]


def _replayed(algo, seed, masks, p, batch_clients):
    """The reference server's draws for ``masks`` (server.py's sampling
    hooks on fold_in(key(seed), t)), as a one-trial record."""
    base = jax.random.key(seed)
    clients, coins = [], []
    for t, mask in enumerate(masks):
        key = jax.random.fold_in(base, t)
        neg_inf = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
        if algo == "deep_svrp":
            coins.append(bool(jax.random.bernoulli(key, jnp.asarray(p, jnp.float64))))
            continue
        key_m, key_c = (key, None) if algo == "sppm" else jax.random.split(key)
        if batch_clients is None:
            clients.append(int(jax.random.categorical(key_m, neg_inf)))
        else:
            g = jax.random.gumbel(key_m, (M,)) + neg_inf
            clients.append(np.asarray(jax.lax.top_k(g, batch_clients)[1]))
        if key_c is not None:
            coins.append(bool(jax.random.bernoulli(key_c, jnp.asarray(p, jnp.float64))))
    return Draws(None if not clients else torch.as_tensor(np.array(clients), dtype=torch.int64),
                 None if not coins else torch.as_tensor(coins), batched=False)


def test_client_stream_masks_equal_the_reference():
    for seed, kw in ((0, {}), (3, dict(churn=0.9, min_resident=4)), (5, dict(churn=0.05))):
        ref, port = RefClientStream(M, seed=seed, **kw), ClientStream(M, seed=seed, **kw)
        for _ in range(60):
            a, b = ref.tick(), port.tick()
            np.testing.assert_array_equal(b, a)
            assert b.sum() >= port.min_resident


@pytest.mark.parametrize("algo", ["sppm", "svrp", "svrp_minibatch", "deep_svrp"])
def test_server_matches_reference_under_replayed_draws(probs, algo):
    q, pq = probs
    kw = _cases(q)[algo]
    seed, stream_seed = 3, 11
    ref = RefFedRoundServer(algo, q, stream=RefClientStream(M, seed=stream_seed, **STREAM),
                            seed=seed, **kw)
    want = ref.run(ROUNDS)
    p = kw["hparams"].get("p", kw["hparams"].get("anchor_prob"))
    draws = _replayed(algo, seed, _masks(stream_seed, ROUNDS), p, kw.get("batch_clients"))
    srv = FedRoundServer(algo, pq, stream=ClientStream(M, seed=stream_seed, **STREAM), seed=seed,
                         draws=draws, device="cpu", **kw)
    got = srv.run(ROUNDS)
    assert got.rounds == want.rounds == ROUNDS and srv.rounds_done == ROUNDS
    trace, ref_trace = got.trace(), want.trace()
    np.testing.assert_array_equal(trace[:, 2], ref_trace[:, 2])
    np.testing.assert_array_equal(got.comm, want.comm)
    np.testing.assert_array_equal(got.comm_bytes, want.comm_bytes)
    np.testing.assert_array_equal(got.flops, want.flops)
    np.testing.assert_allclose(trace[:, 1], ref_trace[:, 1], **TOL)
    np.testing.assert_allclose(srv.x.numpy(), np.asarray(ref.x), rtol=1e-6, atol=1e-12)
    s = got.summary()
    assert np.isfinite([s["p50_ms"], s["p95_ms"], s["p99_ms"], s["gflops_per_sec"]]).all()


@pytest.mark.parametrize("algo", ["sppm", "svrp", "svrp_minibatch"])
def test_native_draws_touch_only_resident_clients(probs, algo):
    q, pq = probs
    kw = _cases(q)[algo]
    stream = ClientStream(M, seed=2, **STREAM)
    srv = FedRoundServer(algo, pq, stream=stream, seed=4, device="cpu", **kw)
    picked = set()
    for k in range(40):
        srv.run(1)
        pick = srv._source.clients[k].reshape(-1).numpy()
        assert stream.mask[pick].all(), (k, pick, stream.mask)
        assert len(set(pick.tolist())) == pick.size  # cohorts without replacement
        picked.update(pick.tolist())
    assert len(picked) > M // 2  # the draws move over the population
    comm = np.asarray(srv.stats.comm)
    assert (np.diff(comm) > 0).all() and np.isfinite(srv.stats.dist_sq).all()
    if algo != "sppm":  # variance reduced: real progress under churn
        assert srv.stats.dist_sq[-1] < 1e-2 * srv.stats.dist_sq[0]


def test_replayed_pick_must_be_resident(probs):
    q, pq = probs
    masks = _masks(11, 3)
    absent = int(np.flatnonzero(~masks[0])[0])
    draws = Draws(torch.full((3,), absent), torch.zeros(3, dtype=torch.bool), batched=False)
    srv = FedRoundServer("svrp", pq, stream=ClientStream(M, seed=11, **STREAM), draws=draws,
                         device="cpu", **_cases(q)["svrp"])
    with pytest.raises(ValueError, match="not all resident"):
        srv.run(1)


def test_server_refusals_match_the_reference(probs):
    q, pq = probs
    calls = [
        lambda S, p, **k: S("sgd", p, hparams={"stepsize": 0.1}, **k),
        lambda S, p, **k: S("svrp_minibatch", p, hparams={"eta": 0.1, "p": 0.2}, **k),
        lambda S, p, **k: S("svrp", p, hparams={"eta": 0.1}, **k),
        lambda S, p, **k: S("svrp", p, hparams={"eta": 0.1, "p": 0.2, "bogus": 1}, **k),
    ]
    for call in calls:
        with pytest.raises(ValueError) as r:
            call(RefFedRoundServer, q)
        with pytest.raises(ValueError) as t:
            call(FedRoundServer, pq, device="cpu")
        assert str(t.value) == str(r.value)
    with pytest.raises(ValueError) as r:
        RefFedRoundServer("svrp_minibatch", q, hparams={"eta": 0.1, "p": 0.2}, batch_clients=8,
                          stream=RefClientStream(M, min_resident=3))
    with pytest.raises(ValueError) as t:
        FedRoundServer("svrp_minibatch", pq, hparams={"eta": 0.1, "p": 0.2}, batch_clients=8,
                       stream=ClientStream(M, min_resident=3), device="cpu")
    assert str(t.value) == str(r.value) and "min_resident" in str(t.value)
