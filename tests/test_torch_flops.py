"""The port's FLOPs accounting (`repro_torch.core.flops`, `launch.roofline`,
`utils.roofline`) against `repro`'s: host numpy on both sides, so EXACTLY
equal.

For every `ALGOS` entry, every registry prox solver its problem family
takes, with and without a lossy channel, and each problem family
(quadratic, logistic, their DP-ERM forms, the federated LM at the reduced
sizes of tests/test_torch_fed_lm.py): `round_model` (every field, the
detail dict included), `round_cost`, `sweep_flops`, `flops_at`,
`ledger_flops` and `tick_flops` equal the reference's.  `problem_prims`,
the forward cost `_fwd_cost`, the peak table's GPU row, `get_peak("gpu")`
and `mfu` too; the CPU peak is measured and cached; unknown inputs raise
the reference's errors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.core import flops as rflops  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.problems import make_a9a_like_problem, make_synthetic_quadratic  # noqa: E402
from repro.problems.dp_erm import make_dp_logistic as ref_dp_logistic  # noqa: E402
from repro.problems.dp_erm import make_dp_quadratic as ref_dp_quadratic  # noqa: E402
from repro.problems.fed_lm import make_fed_lm_problem as ref_make_fed_lm  # noqa: E402
from repro.utils import roofline as rutil  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.convert import problem_from_arrays  # noqa: E402
from repro_torch.core import flops as tflops  # noqa: E402
from repro_torch.experiments import ALGOS  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.problems.dp_erm import make_dp_logistic, make_dp_quadratic  # noqa: E402
from repro_torch.problems.fed_lm import make_fed_lm_problem  # noqa: E402
from repro_torch.utils import roofline as tutil  # noqa: E402

M = 6


def _lm_cfg(registry):
    d, L, h, kv, ff, vocab = 64, 2, 4, 2, 128, 128
    return dataclasses.replace(
        registry["llama3.2-3b"].reduced(), num_layers=L, d_model=d, num_heads=h,
        num_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab_size=vocab,
        param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def families():
    """family -> (reference problem, port problem) of the same shapes."""
    q = make_synthetic_quadratic(num_clients=M, dim=5, mu=1.0, L=50.0, delta=3.0, seed=2)
    pq = problem_from_arrays("quadratic", {"A": np.asarray(q.A), "b": np.asarray(q.b)},
                             device="cpu")
    lg = make_a9a_like_problem(num_clients=M, n_per_client=30, n_pool=200, dim=8,
                               nnz_per_row=3, seed=1)
    pl = problem_from_arrays("logistic", {"Z": np.asarray(lg.Z), "y": np.asarray(lg.y),
                                          "lam": lg.lam}, device="cpu")
    key = jax.random.key(0)
    jlm, _ = ref_make_fed_lm(_lm_cfg(JREG), num_clients=3, per_client_batch=2, seq_len=16,
                             alpha=0.3, seed=0)
    tlm, _ = make_fed_lm_problem(_lm_cfg(REGISTRY), num_clients=3, per_client_batch=2,
                                 seq_len=16, alpha=0.3, seed=0, device="cpu")
    return {
        "quadratic": (q, pq),
        "logistic": (lg, pl),
        "dp_quadratic": (ref_dp_quadratic(q, key, sigma=1.0, clip=1.0, n_per_client=30),
                         make_dp_quadratic(pq, sigma=1.0, clip=1.0, n_per_client=30)),
        "dp_logistic": (ref_dp_logistic(lg, key, sigma=1.0, clip=1.0),
                        make_dp_logistic(pl, sigma=1.0, clip=1.0)),
        "fed_lm": (jlm, tlm),
    }


# Each algorithm's static config (the keys round_model reads), per solver.
STATIC = {
    "sppm": dict(num_steps=10),
    "svrp": dict(num_steps=10),
    "svrp_minibatch": dict(num_steps=10, batch_clients=3),
    "catalyzed_svrp": dict(num_outer=3, inner_steps=7),
    "composite": dict(num_steps=10, prox_steps=40),
    "deep_svrp": dict(num_steps=10, local_steps=3),
    "sgd": dict(num_steps=10),
    "svrg": dict(num_steps=10),
    "scaffold": dict(num_rounds=10, local_steps=4),
    "dane": dict(num_rounds=10, surrogate_client=0),
    "acc_extragradient": dict(num_rounds=10, surrogate_client=0),
}
SOLVERS = {"quadratic": ("exact", "spectral", "gd", "newton", "newton-cg", "newton-fixed25"),
           "logistic": ("exact", "gd", "newton", "newton-cg")}
PROX_ALGOS = ("sppm", "svrp", "svrp_minibatch", "catalyzed_svrp")


def _configs(algo, family):
    """(static) configs of ``algo`` on ``family`` that the reference models."""
    if family == "fed_lm":
        return [dict(STATIC[algo], channel=ch) for ch in (None, "quant8")]
    base = "quadratic" if "quadratic" in family else "logistic"
    if algo in PROX_ALGOS:
        return [dict(STATIC[algo], prox_solver=s, prox_steps=20, channel=ch)
                for s in SOLVERS[base] for ch in (None, "quant8", "cast16")]
    return [dict(STATIC[algo], channel=ch) for ch in (None, "cast")]


def _equal_models(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_equal(a, b, err_msg=name)  # NaN equal to NaN
        assert type(a) is type(b), (name, a, b)


@pytest.mark.parametrize("family", ["quadratic", "logistic", "dp_quadratic", "dp_logistic",
                                    "fed_lm"])
def test_problem_prims_equal(families, family):
    rp, tp = families[family]
    got, want = tflops.problem_prims(tp), rflops.problem_prims(rp)
    np.testing.assert_equal(dataclasses.asdict(got), dataclasses.asdict(want))
    assert got.federated_full_grad_flops == want.federated_full_grad_flops


# The federated LM runs DeepSVRP only (the reference models no other
# algorithm on it).
MODEL_CASES = [(a, f) for f in ("quadratic", "logistic", "dp_quadratic", "dp_logistic")
               for a in sorted(ALGOS)] + [("deep_svrp", "fed_lm")]


@pytest.mark.parametrize("algo,family", MODEL_CASES)
def test_round_model_and_evaluations_equal(families, algo, family):
    """Every model field and every evaluation, exactly."""
    rp, tp = families[family]
    rng = np.random.default_rng(0)
    configs = _configs(algo, family)
    assert configs
    for static in configs:
        want = rflops.round_model(algo, rp, **static)
        got = tflops.round_model(algo, tp, **static)
        _equal_models(got, want)
        p = 0.3
        assert tflops.round_cost(algo, tp, p=p, **static) == rflops.round_cost(algo, rp, p=p,
                                                                               **static)
        body = {k: v for k, v in static.items() if k not in ("num_steps", "num_rounds")}
        for include_init in (True, False):
            assert (tflops.sweep_flops(algo, tp, num_rounds=17, num_trials=3, p=p,
                                       include_init=include_init, **body)
                    == rflops.sweep_flops(algo, rp, num_rounds=17, num_trials=3, p=p,
                                          include_init=include_init, **body))
        # A (trials, rounds) comm trajectory with refreshes where the model has them.
        steps = want.comm_base + want.comm_refresh * (rng.random((3, 9)) < 0.4)
        comm = want.comm_init + np.cumsum(steps, axis=1)
        k = np.arange(1, 10)
        np.testing.assert_array_equal(tflops.flops_at(got, k, comm),
                                      rflops.flops_at(want, k, comm))
        cfg = dict(static, prox_R=None)
        np.testing.assert_array_equal(tflops.ledger_flops(algo, cfg, tp, comm),
                                      rflops.ledger_flops(algo, cfg, rp, comm))
        for prev, rounds in ((0, 1), (0, 5), (4, 3), (6, 1)):
            delta = float(comm[0, prev + rounds - 1] - (comm[0, prev - 1] if prev else 0))
            assert (tflops.tick_flops(got, delta, rounds, prev)
                    == rflops.tick_flops(want, delta, rounds, prev))


def test_fwd_cost_equal_for_every_config():
    """The forward cost over each package's own config, for every family the
    port's registry carries, at its full size and reduced."""
    for name, cfg in REGISTRY.items():
        for tc, jc in ((cfg, JREG[name]), (cfg.reduced(), JREG[name].reduced())):
            for args in ((4096.0, 2.0, 2048.0, 1024.0), (8.0, 8.0, 1.0, 512.0)):
                assert troof._fwd_cost(tc, *args) == rroof._fwd_cost(jc, *args), name


def test_peaks_and_mfu_equal():
    assert tutil.PEAKS["gpu"] == tutil.BackendPeak(*dataclasses.astuple(rutil.PEAKS["gpu"]))
    assert dataclasses.astuple(tutil.get_peak("gpu")) == dataclasses.astuple(
        rutil.get_peak("gpu"))
    for rate in (1.0e12, 3.3e14, 989e12):
        assert tutil.mfu(rate, "gpu") == rutil.mfu(rate, "gpu")
    assert tutil.default_platform() == ("gpu" if torch.cuda.is_available() else "cpu")


def test_cpu_peak_calibrated_and_cached():
    a = tutil.calibrated_cpu_peak("float32", n=128, reps=2)
    assert a.flops > 0 and a.hbm_bw is None and "calibrated" in a.source
    assert tutil.calibrated_cpu_peak("float32", n=128, reps=2) is a
    assert tutil.get_peak("cpu", dtype="float64").flops > 0


def test_unknown_inputs_raise_the_reference_errors(families):
    _, pq = families["quadratic"]
    rq, _ = families["quadratic"]
    for bad in (lambda f, p: f.round_model("bogus", p, num_steps=1),
                lambda f, p: f.round_model("svrp", p, prox_solver="bogus"),
                lambda f, p: f.round_model("svrp", p, channel="bogus"),
                lambda f, p: f.problem_prims(object())):
        with pytest.raises(ValueError) as t:
            bad(tflops, pq)
        with pytest.raises(ValueError) as r:
            bad(rflops, rq)
        assert str(t.value).split(";")[0] == str(r.value).split(";")[0]
    with pytest.raises(ValueError, match="no peak entry"):
        tutil.get_peak("tpu-v99")
