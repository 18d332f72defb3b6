"""The port's shard modes (`run_batch(shard="data" | "clients")`,
`open_session(substrate="clients")`) against `repro` and against the
port's unsharded runs, in a world of 4 gloo ranks on the CPU.

One world for the module (tests/_torch_shard_world.py: spawned ranks,
a 120 s timeout on the group and on the join) runs every case; the ranks
import `repro_torch` only, and the parent computes the reference's sweeps
while they run, on the same problems (the reference's numpy arrays) with
the reference's draws replayed (tests/_torch_replay.py).  The tolerances
are tests/test_client_sharded.py's: dist_sq and x_final rtol 1e-5, comm
integer-equal with the same dtype.

* pads: svrp with M = 10 (12 on 4 ranks) and M = 5 (8: rank 3 holds only
  pads), the comm increments in {2, 2 + 3M} for the true M;
* minibatch, fused svrp (K1's loop form, plain on the CPU), fused and
  quant8 deep_svrp, DP-ERM logistic svrp fused (K2 with the noise fold and
  a padded ``dp_shift``), each against the reference;
* the collective model, the counterpart of the reference's HLO count:
  sppm K all_reduces in K rounds, svrp 1 + K + its refresh rounds,
  ``shard="data"`` one;
* the view path (scaffold, dane, catalyzed_svrp, composite) against the
  port's unsharded sweep;
* ``shard="data"`` (svrp B = 6 padded to 8, fused deep_svrp) bit for bit
  against the unsharded sweep;
* sessions (svrp stepped 7 then the rest, scaffold) against `run_batch`;
* every rank's result equals rank 0's bit for bit.

In the parent, with no world: the refusals (the reference's texts where it
has the same check) and the world of one, which equals the unsharded run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_replay import replay_draws  # noqa: E402
from _torch_shard_world import run_world  # noqa: E402

from repro.core import theorem2_stepsize, theorem3_gamma  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.problems import dp_erm as rdp  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
from repro.problems.client_shard import check_client_shardable as ref_check  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import composite as tcomp  # noqa: E402
from repro_torch.experiments import RunSpec, run_batch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.problems.client_shard import (  # noqa: E402
    ClientShardedProblem,
    check_client_shardable,
    client_block,
    pad_clients,
    shard_clients,
)
from repro_torch.problems.quadratic import QuadraticProblem  # noqa: E402

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-24)
X_TOL = dict(rtol=1e-5, atol=1e-12)
L2_RADIUS = 0.1


def _quad(M, seed):
    q = make_synthetic_quadratic(num_clients=M, dim=6, mu=1.0, L=80.0, delta=4.0, seed=seed)
    return q, {"kind": "quadratic", "A": np.asarray(q.A), "b": np.asarray(q.b)}


def _trials(algo, port_problem, kw):
    """The sweep's (seeds, p) trial table, as both packages lay it out."""
    static = {k: v for k, v in kw.items() if k not in ("grid", "seeds", "x_star")}
    x_star = None if "x_star" not in kw else torch.tensor(kw["x_star"])
    rr = RunSpec(algo, grid=kw["grid"], seeds=kw.get("seeds", 1), x_star=x_star,
                 static=static).resolve(port_problem)
    return rr.seeds, rr.hparams.get("p", rr.hparams.get("anchor_prob"))


def _plan():
    """(cases for the ranks, their inputs, the reference's problems)."""
    q10, a10 = _quad(10, 1)
    q5, a5 = _quad(5, 1)
    q16, a16 = _quad(16, 3)
    base = make_a9a_like_problem(num_clients=6, n_per_client=30, n_pool=300, dim=16, seed=2)
    dp = rdp.make_dp_logistic(base, jax.random.key(12), sigma=2.0, clip=1.0)
    a_dp = {"kind": "logistic", "Z": np.asarray(dp.Z), "y": np.asarray(dp.y), "lam": dp.lam,
            "dp_shift": np.asarray(dp.dp_shift), "dp_sigma": 2.0, "dp_clip": 1.0}
    inputs = {"q10": a10, "q5": a5, "q16": a16, "dp": a_dp}
    refs = {"q10": q10, "q5": q5, "q16": q16, "dp": dp}
    port = {k: problem_from_arrays(v["kind"], v, device="cpu") for k, v in inputs.items()}

    def eta_of(q):
        return theorem2_stepsize(float(q.strong_convexity()), float(q.similarity()))

    eta, L = eta_of(q10), float(q10.smoothness_max())
    eta16, L16 = eta_of(q16), float(q16.smoothness_max())
    mu, delta = float(q10.strong_convexity()), float(q10.similarity())
    gamma = max(theorem3_gamma(mu, delta, 10), 0.5)
    deep = dict(grid={"eta": 0.5, "local_lr": 0.8 / (L + 2.0), "anchor_prob": 0.25}, seeds=3,
                num_steps=30, local_steps=4)
    x_dp = np.asarray(dp.minimizer())
    x_c = tcomp.composite_minimizer_pgd(port["q10"], tcomp.prox_l2ball(L2_RADIUS),
                                        L=float(q10.smoothness()), num_steps=3000).numpy()
    svrp120 = dict(grid={"eta": [eta, eta / 2], "p": 0.2}, seeds=3, num_steps=120)
    cases = {
        # against the reference (its draws replayed)
        "svrp_M10_pads": dict(problem="q10", algo="svrp", kw=svrp120),
        "svrp_M5_pad_rank": dict(problem="q5", algo="svrp", kw=dict(
            svrp120, grid={"eta": [eta_of(q5), eta_of(q5) / 2], "p": 0.2})),
        "minibatch_M16": dict(problem="q16", algo="svrp_minibatch", kw=dict(
            grid={"eta": 3 * eta16, "p": 0.25}, seeds=3, num_steps=60, batch_clients=4)),
        "svrp_fused_M16": dict(problem="q16", algo="svrp", fused=True, kw=dict(
            svrp120, grid={"eta": [eta16, eta16 / 2], "p": 0.2, "smoothness": L16},
            prox_solver="gd", prox_steps=20)),
        "deep_fused": dict(problem="q10", algo="deep_svrp", fused=True, kw=deep),
        "deep_quant8": dict(problem="q10", algo="deep_svrp", kw=dict(deep, channel="quant8")),
        "dp_logistic_fused": dict(problem="dp", algo="svrp", fused=True, kw=dict(
            svrp120, grid={"eta": [0.5, 1.0], "p": 0.3, "smoothness": float(dp.smoothness_max())},
            prox_solver="gd", prox_steps=15, x_star=x_dp)),
        # the collective model
        "sppm_count": dict(problem="q10", algo="sppm", unsharded=True, kw=dict(
            grid={"eta": [0.05, 0.1]}, seeds=2, num_steps=30)),
        # the view path, against the port's unsharded sweep
        "view_scaffold": dict(problem="q10", algo="scaffold", unsharded=True, kw=dict(
            grid={"local_lr": 1 / (4 * L)}, seeds=2, num_rounds=12, local_steps=4)),
        "view_dane": dict(problem="q10", algo="dane", unsharded=True, kw=dict(
            grid={"theta": float(q10.similarity_max())}, num_rounds=8)),
        "view_catalyzed_svrp": dict(problem="q10", algo="catalyzed_svrp", unsharded=True, kw=dict(
            grid={"mu": mu, "gamma": gamma, "eta": theorem2_stepsize(mu + gamma, delta),
                  "p": 0.1}, seeds=2, num_outer=2, inner_steps=12)),
        "view_composite": dict(problem="q10", algo="composite", unsharded=True, prox_R=L2_RADIUS,
                               kw=dict(grid={"eta": [eta, eta / 2], "p": 0.2, "smoothness": L,
                                             "mu": mu}, seeds=2, num_steps=12, x_star=x_c)),
        # shard="data", against the port's unsharded sweep
        "data_svrp": dict(problem="q10", algo="svrp", shard="data", unsharded=True, kw=dict(
            grid={"eta": [eta, eta / 2], "p": 0.2}, seeds=3, num_steps=40)),
        "data_deep_fused": dict(problem="q10", algo="deep_svrp", shard="data", fused=True,
                                unsharded=True, kw=dict(deep, seeds=6, num_steps=20)),
        # sessions
        "session_svrp": dict(problem="q10", algo="svrp", session=(7, 33), unsharded=True,
                             kw=dict(grid={"eta": [0.02, 0.01], "p": 0.2}, seeds=2,
                                     num_steps=40)),
        "session_scaffold": dict(problem="q10", algo="scaffold", session=(20,), unsharded=True,
                                 kw=dict(grid={"local_lr": 1 / 320.0}, seeds=2, num_rounds=20,
                                         local_steps=4)),
    }
    for name in REFERENCE_CASES:
        case = cases[name]
        kw = case["kw"]
        seeds, p = _trials(case["algo"], port[case["problem"]], kw)
        cfg = {k: v for k, v in kw.items() if k not in ("grid", "seeds", "x_star")}
        case["draws"] = replay_draws(case["algo"], seeds, refs[case["problem"]].num_clients,
                                     cfg, p)
    for case in cases.values():
        case.setdefault("shard", "clients")
        if case.pop("fused", False):
            case["kw"] = dict(case["kw"], fused=True)
    return cases, inputs, refs


# The reference's svrp-pattern sweeps share one (rounds, trials) shape, so
# replaying their draws compiles once.
REFERENCE_CASES = ("svrp_M10_pads", "svrp_M5_pad_rank", "minibatch_M16", "svrp_fused_M16",
                   "deep_fused", "deep_quant8", "dp_logistic_fused")
VIEW_CASES = ("view_scaffold", "view_dane", "view_catalyzed_svrp", "view_composite")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the 4 ranks, the reference's sweeps computed meanwhile."""
    cases, inputs, refs = _plan()
    join = run_world(cases, inputs, WORLD, str(tmp_path_factory.mktemp("world")))
    want = {}
    for name in REFERENCE_CASES:
        case = cases[name]
        kw = {k: v for k, v in case["kw"].items()}
        if "x_star" in kw:
            kw["x_star"] = jax.numpy.asarray(kw["x_star"])
        want[name] = ref_run_batch(case["algo"], refs[case["problem"]], **kw)
    return cases, join(), want


def _check(got, want, tol=TOL):
    np.testing.assert_allclose(got["dist_sq"], np.asarray(want["dist_sq"]), **tol)
    np.testing.assert_array_equal(got["comm"], np.asarray(want["comm"]))
    assert got["comm"].dtype == np.asarray(want["comm"]).dtype
    np.testing.assert_allclose(got["x_final"], np.asarray(want["x_final"]), **X_TOL)


def _fields(res):
    return {f: np.asarray(getattr(res, f)) for f in ("dist_sq", "comm", "x_final")}


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_client_sharded_matches_reference(world, name):
    cases, ranks, want = world
    _check(ranks[0][name], _fields(want[name]))


@pytest.mark.parametrize("name", ["svrp_M10_pads", "svrp_M5_pad_rank"])
def test_comm_counts_the_true_clients(world, name):
    """The pads are never sampled and never counted: every round adds 2 or
    a refresh's 2 + 3M for the true M."""
    cases, ranks, _ = world
    M = {"q10": 10, "q5": 5}[cases[name]["problem"]]
    incs = set(np.unique(np.diff(ranks[0][name]["comm"], axis=1)).tolist())
    assert incs <= {2, 2 + 3 * M} and 2 + 3 * M in incs, incs


@pytest.mark.parametrize("name,expect", [
    ("sppm_count", lambda r, K: K),
    ("svrp_M10_pads", lambda r, K: 1 + K + r["refresh_rounds"]),
    ("data_svrp", lambda r, K: 1),
])
def test_collective_model(world, name, expect):
    """sppm: one all_reduce a round; svrp: the round-0 anchor, one a round
    and one a refresh event; shard="data": the assembly alone."""
    cases, ranks, _ = world
    for rank in ranks:
        r = rank[name]
        assert r["all_reduces"] == expect(r, r["dist_sq"].shape[1]), (name, r["all_reduces"])


@pytest.mark.parametrize("name", ("sppm_count",) + VIEW_CASES)
def test_view_path_matches_unsharded(world, name):
    """Algorithms outside ROUND_DEFS run their drivers against the
    ClientShardedProblem view, and sppm its rounds: equal to the unsharded
    sweep to 1e-5."""
    _, ranks, _ = world
    _check(ranks[0][name], ranks[0][name]["unsharded"])


@pytest.mark.parametrize("name", ["data_svrp", "data_deep_fused"])
def test_data_shard_is_bit_for_bit(world, name):
    _, ranks, _ = world
    got, want = ranks[0][name], ranks[0][name]["unsharded"]
    for f in ("dist_sq", "comm", "x_final"):
        assert got[f].dtype == want[f].dtype
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("name", ["session_svrp", "session_scaffold"])
def test_client_session_matches_run_batch(world, name):
    """A clients session stepped in chunks equals run_batch(shard="clients")
    bit for bit, and the unsharded run_batch to 1e-5 with comm equal."""
    _, ranks, _ = world
    got = ranks[0][name]
    for f in ("dist_sq", "comm", "x_final"):
        np.testing.assert_array_equal(got[f], got["run_batch"][f], err_msg=f)
    _check(got, got["unsharded"])


def test_every_rank_agrees(world):
    """Every rank returns rank 0's result, bit for bit, in every case."""
    cases, ranks, _ = world
    for name in cases:
        for r in range(1, WORLD):
            for f in ("dist_sq", "comm", "x_final"):
                np.testing.assert_array_equal(ranks[r][name][f], ranks[0][name][f],
                                              err_msg=f"{name} rank {r} {f}")


# ------------------------------------------------------------- no world
@pytest.fixture(scope="module")
def q10():
    ref, arrays = _quad(10, 1)
    return ref, problem_from_arrays("quadratic", arrays, device="cpu")


def test_world_of_one_equals_unsharded(q10):
    """One process, a private gloo world of one: the same collectives, the
    unsharded results (data bit for bit, clients to 1e-5), and no default
    group left behind."""
    _, pq = q10
    kw = dict(grid={"eta": [0.02, 0.01], "p": 0.2}, seeds=2, num_steps=20, device="cpu")
    plain = run_batch("svrp", pq, **kw)
    n0 = tmesh.all_reduce.all_reduces
    data = run_batch("svrp", pq, shard="data", **kw)
    assert tmesh.all_reduce.all_reduces == n0 + 1
    for f in ("dist_sq", "comm", "x_final"):
        assert torch.equal(getattr(data, f), getattr(plain, f)), f
    _check(_fields(run_batch("svrp", pq, shard="clients", **kw)), _fields(plain))
    assert not torch.distributed.is_initialized()


def test_blocks_and_padding(q10):
    """pad_clients appends zero clients; shard_clients cuts a rank's
    contiguous block of the padded axis; non-client-major fields raise."""
    _, pq = q10
    padded = pad_clients(pq, 12)
    assert padded.num_clients == 12 and torch.equal(padded.A[:10], pq.A)
    assert not padded.A[10:].any() and not padded.b[10:].any()
    assert pad_clients(pq, 10) is pq
    mesh = tmesh.Mesh("clients", None, 2, 4)
    local, valid = shard_clients(pq, mesh)
    assert torch.equal(local.A, padded.A[6:9]) and local.A.is_contiguous()
    assert valid.tolist() == [True] * 10 + [False] * 2
    assert torch.equal(client_block(pq, 9, 12).b[0], pq.b[9])
    from repro_torch.problems.quadratic import stack_quadratics

    with pytest.raises(ValueError, match="not client-major"):
        pad_clients(stack_quadratics([pq, pq]), 24)


class _Undeclared(QuadraticProblem):
    client_shardable = False


@pytest.mark.parametrize("what", ["undeclared", "fused_svrg", "fed_lm", "unknown_mode",
                                  "group_without_shard"])
def test_refusals(q10, what):
    """Refused before anything runs; where the reference has the same check,
    with its text."""
    ref_q, pq = q10
    kw = dict(grid={"eta": 0.1, "p": 0.1}, num_steps=5, device="cpu")
    if what == "undeclared":
        bad = _Undeclared(A=pq.A, b=pq.b)
        with pytest.raises(ValueError) as t:
            run_batch("svrp", bad, shard="clients", **kw)
        with pytest.raises(ValueError) as r:
            ref_check(type("_Undeclared", (), {})())
        assert str(t.value) == str(r.value)
    elif what == "fused_svrg":
        with pytest.raises(ValueError) as t:
            run_batch("svrg", pq, grid={"stepsize": 1e-3, "p": 0.1}, num_steps=5,
                      shard="clients", fused=True, device="cpu")
        with pytest.raises(ValueError) as r:
            ref_run_batch("svrg", ref_q, grid={"stepsize": 1e-3, "p": 0.1}, num_steps=5,
                          shard="clients", fused=True)
        assert str(t.value) == str(r.value)
    elif what == "fed_lm":
        from repro.problems.fed_lm import FedLMProblem as RefFedLM
        from repro_torch.problems.fed_lm import FedLMProblem

        with pytest.raises(ValueError) as t:
            check_client_shardable(object.__new__(FedLMProblem))
        with pytest.raises(ValueError) as r:
            ref_check(object.__new__(RefFedLM))
        assert str(t.value) == str(r.value)
    elif what == "unknown_mode":
        with pytest.raises(ValueError) as t:
            run_batch("svrp", pq, shard="trials", **kw)
        with pytest.raises(ValueError) as r:
            ref_run_batch("svrp", ref_q, grid={"eta": 0.1, "p": 0.1}, num_steps=5, shard="trials")
        assert str(t.value) == str(r.value)
    else:
        with pytest.raises(ValueError, match="group= only applies with shard="):
            run_batch("svrp", pq, group=object(), **kw)


def test_view_forwards_no_raw_data(q10):
    """The view answers oracles only, so `_surrogate_min` takes its Newton
    route; its num_clients is the global M."""
    _, pq = q10
    mesh = tmesh.make_client_mesh(device="cpu")
    local, valid = shard_clients(pq, mesh)
    view = ClientShardedProblem(local, valid, mesh, pq.num_clients)
    assert not any(hasattr(view, a) for a in ("A", "b", "Z", "y"))
    assert view.num_clients == 10 and view.dim == 6
    x = torch.randn(3, 6, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    m = torch.tensor([0, 4, 9])
    assert torch.equal(view.grad(m, x), pq.grad(m, x))
    torch.testing.assert_close(view.full_grad(x), pq.full_grad(x), rtol=1e-12, atol=1e-12)
