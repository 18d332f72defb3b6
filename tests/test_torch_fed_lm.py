"""The port's federated LM problem and DeepSVRP on it, against `repro`, on the CPU.

`examples/fed_transformer.py`'s ``cpu-small`` preset (d 64, 2 layers, 4/2
heads, Dh 16, vocab 128) in float32, 3 clients of 2 x 16 tokens.  The
reference's initial parameters cross as numpy (`convert.fed_lm_x0_from_numpy`),
the tokens come from the same numpy seed, and DeepSVRP's refresh coins are
the reference's own, replayed from its keys (tests/_torch_replay.py).

Tolerances: tokens integer-equal; x0 bit for bit; the loss and metric rtol
1e-5, gradients atol 1e-5 / rtol 1e-4 (float32, summation order only, as
tests/test_torch_train.py); the engine's loss trajectory ``ROUND_TOL
["float32"]`` (rtol 1e-4, atol 1e-6) on identity; comm and comm_bytes equal
everywhere.  On quant8 the loss is held to rtol 1e-3: float32 rounding can
move a value across an int8 rounding boundary, and one flipped level moves
that value by a whole step, amax/127 of its 256-value block (<= 0.8% of the
block's largest value); over 3 rounds such flips move the mean loss by less
than 1e-3 of itself.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import (  # noqa: E402
    ROUND_TOL,
    randomize_recurrent,
    reference_params,
    replay_draws,
)
from repro.configs import REGISTRY as JREG  # noqa: E402
from repro.experiments import run_batch as ref_run_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.problems import make_fed_lm_problem as ref_make_fed_lm  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.convert import fed_lm_x0_from_numpy  # noqa: E402
from repro_torch.core import Draws  # noqa: E402
from repro_torch.experiments import run_batch, run_sequential  # noqa: E402
from repro_torch.problems.fed_lm import (  # noqa: E402
    make_fed_lm_problem,
    param_layout,
    ravel_params,
    unravel,
)

M_CLIENTS, BSZ, SEQ, SEED = 3, 2, 16, 0
GRID = {"eta": 1.0, "local_lr": 0.2, "anchor_prob": 0.5}
ROUNDS, LOCAL_STEPS = 3, 2
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
QUANT8_RTOL = 1e-3
# DeepSVRP's loss over the recurrent families, the port's against the
# reference's, both float32.  Measured against both packages run in float64
# (tests/measure_f32_drift.py): the reference's loss lies up to 9.94e-6 from
# it (zamba2; rwkv6 2.09e-6), the port's up to 9.4e-7 (rwkv6; zamba2
# 8.6e-8), so the two lie within 1.003e-5 of each other: the gap is the
# reference's float32 summation order, the port being the nearer to float64.
DIST_RTOL = 1.2e-5


def _cfg(registry):
    """fed_transformer.py's cpu-small preset."""
    d, L, h, kv, ff, vocab = 64, 2, 4, 2, 128, 128
    return dataclasses.replace(
        registry["llama3.2-3b"].reduced(), num_layers=L, d_model=d, num_heads=h,
        num_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab_size=vocab,
        param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fed():
    """Both packages' problems on the same tokens, from the same x0."""
    jcfg, tcfg = _cfg(JREG), _cfg(REGISTRY)
    jprob, jx0 = ref_make_fed_lm(jcfg, num_clients=M_CLIENTS, per_client_batch=BSZ,
                                 seq_len=SEQ, alpha=0.3, seed=SEED)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(SEED)))
    tprob, _ = make_fed_lm_problem(tcfg, num_clients=M_CLIENTS, per_client_batch=BSZ,
                                   seq_len=SEQ, alpha=0.3, seed=SEED, device="cpu")
    tx0 = fed_lm_x0_from_numpy(tree, tcfg, device="cpu")
    return jprob, jx0, tprob, tx0


@pytest.fixture(scope="module")
def ref_runs(fed):
    """The reference's run_batch on identity and quant8 (one run each, shared)."""
    jprob, jx0, _, _ = fed
    out = {}
    for channel in (None, "quant8"):
        out[channel] = ref_run_batch("deep_svrp", jprob, grid=GRID, seeds=[1, 2], x0=jx0,
                                     x_star=jx0, num_steps=ROUNDS, local_steps=LOCAL_STEPS,
                                     channel=channel)
    return out


def _coins(res):
    """The reference flips its coins at the iterate's dtype (float32 here)."""
    _, coins = replay_draws("deep_svrp", res.seeds, M_CLIENTS, {"num_steps": ROUNDS},
                            res.hparams["anchor_prob"], dtype=jnp.float32)
    return torch.tensor(coins)


def test_tokens_and_x0_equal_the_reference(fed):
    jprob, jx0, tprob, tx0 = fed
    np.testing.assert_array_equal(tprob.tokens.numpy(), np.asarray(jprob.tokens))
    np.testing.assert_array_equal(tprob.labels.numpy(), np.asarray(jprob.labels))
    assert tprob.tokens.dtype == torch.int64 and tprob.dim == jprob.dim == tx0.numel()
    assert tx0.dtype == torch.float32
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))


def test_ravel_order_sorts_keys_and_unravel_inverts_it():
    tree = {"b": {"z": torch.arange(3.0), "a": torch.ones(2, 2)}, "a": torch.full((1,), 7.0)}
    flat = ravel_params(tree)
    np.testing.assert_array_equal(flat.numpy(), [7, 1, 1, 1, 1, 0, 1, 2])
    back = unravel(flat, param_layout(tree))
    assert torch.equal(back["b"]["a"], tree["b"]["a"]) and torch.equal(back["a"], tree["a"])
    assert back["b"]["z"].data_ptr() == flat[5:].data_ptr()  # views, no copy


def test_oracles_match_the_reference(fed):
    jprob, jx0, tprob, tx0 = fed
    rng = np.random.default_rng(3)
    x = (np.asarray(jx0) + 0.05 * rng.standard_normal(jx0.shape)).astype(np.float32)
    xt = torch.from_numpy(x)
    for m in range(M_CLIENTS):
        np.testing.assert_allclose(tprob.loss(torch.tensor(m), xt).item(),
                                   float(jprob.loss(jnp.asarray(m), jnp.asarray(x))), rtol=1e-5)
        np.testing.assert_allclose(tprob.grad(torch.tensor(m), xt).numpy(),
                                   np.asarray(jprob.grad(jnp.asarray(m), jnp.asarray(x))),
                                   **GRAD_TOL)
    np.testing.assert_allclose(tprob.full_grad(xt).numpy(),
                               np.asarray(jprob.full_grad(jnp.asarray(x))), **GRAD_TOL)
    np.testing.assert_allclose(tprob.metric(xt).item(), float(jprob.metric(jnp.asarray(x))),
                               rtol=1e-5)
    # Lanes: a (2, d) batch with per-row clients, row by row.
    X = torch.stack([xt, tx0])
    ms = torch.tensor([2, 0])
    G = tprob.grad(ms, X)
    for r in range(2):
        torch.testing.assert_close(G[r], tprob.grad(ms[r], X[r]), rtol=0, atol=0)
    torch.testing.assert_close(tprob.metric(X)[1], tprob.metric(tx0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no computable minimizer"):
        tprob.minimizer()


@pytest.mark.parametrize("channel", [None, "quant8"])
@pytest.mark.parametrize("substrate", ["fused", "registry", "sequential"])
def test_deep_svrp_matches_the_reference_run_batch(fed, ref_runs, channel, substrate):
    """run_batch (fused and registry) and run_sequential over the FedLM,
    against the reference's run_batch with its coins replayed."""
    _, _, tprob, tx0 = fed
    ref = ref_runs[channel]
    draws = Draws(None, _coins(ref))
    kw = dict(grid=GRID, seeds=[1, 2], x0=tx0, x_star=tx0, num_steps=ROUNDS,
              local_steps=LOCAL_STEPS, channel=channel, draws=draws, device="cpu")
    if substrate == "sequential":
        got = run_sequential("deep_svrp", tprob, **kw)
    else:
        got = run_batch("deep_svrp", tprob, fused=substrate == "fused", **kw)
    assert got.comm.dtype == torch.int32
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(ref.comm))
    np.testing.assert_array_equal(got.comm_bytes, np.asarray(ref.comm_bytes))
    tol = ROUND_TOL["float32"] if channel is None else dict(rtol=QUANT8_RTOL, atol=0.0)
    np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(ref.dist_sq), **tol)
    loss = got.dist_sq.numpy()
    assert (loss[:, -1] < loss[:, 0]).all()


@pytest.mark.parametrize("name", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_deep_svrp_on_the_recurrent_families_matches_the_reference(name):
    """run_batch("deep_svrp") on the FedLM over the reduced zamba2 and rwkv6
    in float32 (3 clients of 2 x 16 tokens; the weights' zeros and ones
    randomised, `randomize_recurrent`), 2 rounds of 2 local steps, against
    the reference's run_batch with its coins replayed: every gradient
    through the plain K6b and K4b, or K7b; the loss rtol DIST_RTOL, comm and
    comm_bytes equal.  The reference's problem is built as its
    `make_fed_lm_problem` builds it, from the same tokens, around the
    randomised weights (its own eager init of these layers takes seconds)."""
    from jax.flatten_util import ravel_pytree
    from repro.data import SyntheticLMDataset as JDataset
    from repro.problems.fed_lm import FedLMProblem

    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(JREG[name].reduced(), **kw)
    tcfg = dataclasses.replace(REGISTRY[name].reduced(), **kw)
    data = dict(num_clients=M_CLIENTS, per_client_batch=BSZ, seq_len=SEQ, alpha=0.3, seed=SEED)
    tree = randomize_recurrent(reference_params(jcfg, SEED), tcfg.family, 100)
    jx0, unravel = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    ds = JDataset(vocab_size=jcfg.vocab_size, num_clients=M_CLIENTS, alpha=0.3, seed=SEED)
    toks = np.stack([ds.sample(m, BSZ, SEQ) for m in range(M_CLIENTS)])
    jprob = FedLMProblem(tokens=jnp.asarray(toks[:, :, :-1], jnp.int32),
                         labels=jnp.asarray(toks[:, :, 1:], jnp.int32), cfg=jcfg,
                         unravel=unravel, num_params=int(jx0.size))
    tprob, _ = make_fed_lm_problem(tcfg, device="cpu", **data)
    np.testing.assert_array_equal(tprob.tokens.numpy(), np.asarray(jprob.tokens))
    tx0 = fed_lm_x0_from_numpy(tree, tcfg, device="cpu")
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    rounds = 2
    ref = ref_run_batch("deep_svrp", jprob, grid=GRID, seeds=[1], x0=jx0, x_star=jx0,
                        num_steps=rounds, local_steps=LOCAL_STEPS)
    _, coins = replay_draws("deep_svrp", ref.seeds, M_CLIENTS, {"num_steps": rounds},
                            ref.hparams["anchor_prob"], dtype=jnp.float32)
    got = run_batch("deep_svrp", tprob, grid=GRID, seeds=[1], x0=tx0, x_star=tx0,
                    num_steps=rounds, local_steps=LOCAL_STEPS, draws=Draws(None, torch.tensor(coins)),
                    device="cpu")
    np.testing.assert_array_equal(got.comm.numpy(), np.asarray(ref.comm))
    np.testing.assert_array_equal(got.comm_bytes, np.asarray(ref.comm_bytes))
    np.testing.assert_allclose(got.dist_sq.numpy(), np.asarray(ref.dist_sq), rtol=DIST_RTOL)


def test_quant8_prices_a_flat_model_at_a_quarter(fed):
    from repro_torch.core.channel import wire_vector_bytes

    d = fed[3].numel()
    ratio = wire_vector_bytes("quant8", d, 4) / wire_vector_bytes(None, d, 4)
    assert 0.25 < ratio <= 0.27


def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fed_transformer_twin_quick(capsys):
    """examples/fed_transformer_torch.py --quick on the CPU: quant8 at
    0.2539x of float32's bytes with the loss falling, and the qwen2-1.5b dry
    run priced from meta tensors as the reference prices its eval_shape."""
    from repro.core.channel import payload_nbytes as ref_payload_nbytes

    ex = _example("fed_transformer_torch")
    res = ex.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bytes[quant8] / bytes[float32] = 0.2539" in out and "loss decreased" in out
    assert res.dist_sq.shape == (1, 4)
    assert ex.PRESETS == _example("fed_transformer").PRESETS
    shapes = jax.eval_shape(lambda k: JM.init_params(JREG["qwen2-1.5b"], k), jax.random.key(0))
    for name in (None, "quant8", "cast", "cast16"):
        want = ref_payload_nbytes(name, shapes)
        assert f"{want/1e9:8.3f} GB/transfer" in out


def test_fused_needs_a_kernel_oracle_but_for_deep_svrp(fed):
    """deep_svrp's fused path needs only ``problem.grad``; every other
    fusable algorithm still refuses a FedLM with fused_oracle_kind's error."""
    _, _, tprob, tx0 = fed
    with pytest.raises(ValueError, match="no batched kernel prox path for FedLMProblem"):
        run_batch("svrp", tprob, grid={"eta": 1.0, "p": 0.5, "smoothness": 1.0}, x0=tx0,
                  x_star=tx0, num_steps=1, prox_solver="gd", fused=True, device="cpu")
    res = run_batch("deep_svrp", tprob, grid=GRID, x0=tx0, x_star=tx0, num_steps=1,
                    local_steps=1, fused=True, device="cpu")
    assert res.dist_sq.shape == (1, 1) and np.isfinite(res.dist_sq.numpy()).all()
