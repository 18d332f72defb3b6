"""The port's DeepSVRP training path against `repro`, on the CPU.

The reduced qwen2-1.5b config (2 layers, d 256, 4/2 heads, vocab 512) in
float32; the reference's weights and gradients cross into the port as numpy
(`convert.dense_params_from_numpy`), the token batches come from the same
numpy seed, and the refresh coins are the reference's own -- ``bernoulli(
fold_in(rng, step), p)`` (src/repro/core/deep.py:130-131) -- computed here
and injected into the port.  The train step against the reference's
`make_svrp_train_step` is in tests/test_torch_deepsvrp_step.py.

Tolerances: the model's loss rtol 1e-5 and every gradient leaf atol 1e-5,
rtol 1e-4 (float32, summation order only); x, w, gbar and the loss after
each round rtol 1e-4, atol 1e-6.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import (  # noqa: E402
    ROUND_TOL,
    assert_tree_close,
    jax_batch,
    lm_batch,
    mixed_coin_prob,
    np_tree,
    qwen2_configs,
    torch_batch,
)
from repro.core import deep as jdeep  # noqa: E402
from repro.data import ShardedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import client_partition as jclient_partition  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import deep as tdeep  # noqa: E402
from repro_torch.data import ShardedBatcher, SyntheticLMDataset, client_partition  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.prox_update import prox_update  # noqa: E402
from repro_torch.launch import make_svrp_train_step  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.utils.tree import tree_map, value_and_grad  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model's ops are tiny, and with several
    test processes on the host torch's thread pools contend (70x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_launches_nothing():
    prox_update.launches = flash_attention.launches = flash_attention_bwd.launches = 0
    yield
    assert prox_update.launches == flash_attention.launches == flash_attention_bwd.launches == 0


# ------------------------------------------------------------------ (a)
def test_loss_and_gradient_match_reference():
    jcfg, tcfg = qwen2_configs()
    jparams = JM.init_params(jcfg, jax.random.key(0))
    tparams = convert.dense_params_from_numpy(np_tree(jparams), tcfg, device="cpu")
    batch = lm_batch(tcfg.vocab_size, 1, b=2, seq=24)
    want_loss, want_grad = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jax_batch(batch), remat=False)))(jparams)
    loss, grad = value_and_grad(lambda p, b: TM.loss_fn(p, tcfg, b), tparams, torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert_tree_close(grad, np_tree(want_grad), dict(atol=1e-5, rtol=1e-4), "grad")


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("algo", ["deep_svrp", "fedavg", "scaffold"])
def test_rounds_match_reference(algo):
    """3 rounds of `deep_svrp_round` (with the reference's coins, a refresh
    and a plain round among them), `fedavg_round` and `deep_scaffold_round`."""
    jcfg, tcfg = qwen2_configs()
    jparams = JM.init_params(jcfg, jax.random.key(1))
    tparams = convert.dense_params_from_numpy(np_tree(jparams), tcfg, device="cpu")
    batch = lm_batch(tcfg.vocab_size, 1, b=2, seq=16)
    jloss = lambda p, b: JM.loss_fn(p, jcfg, b, remat=False)  # noqa: E731
    tloss = lambda p, b: TM.loss_fn(p, tcfg, b)  # noqa: E731
    tol = ROUND_TOL["float32"]
    if algo == "deep_svrp":
        rng = jax.random.key(3)
        p, coins = mixed_coin_prob(rng)
        cfg = dict(eta=0.5, local_lr=0.2, local_steps=2, anchor_prob=p)
        grad0 = jax.grad(jloss)(jparams, jax_batch(batch))
        jstate = jdeep.deep_svrp_init(jparams, grad0, rng)
        tstate = tdeep.deep_svrp_init(tparams, convert.dense_params_from_numpy(
            np_tree(grad0), tcfg, device="cpu"))
        jround = jax.jit(lambda s, b: jdeep.deep_svrp_round(jloss, s, b,
                                                            jdeep.DeepSVRPConfig(**cfg)))
        for r in range(3):
            jstate, jl = jround(jstate, jax_batch(batch))
            tstate, tl = tdeep.deep_svrp_round(tloss, tstate, torch_batch(batch),
                                               tdeep.DeepSVRPConfig(**cfg), refresh=coins[r])
            np.testing.assert_allclose(tl.item(), float(jl), **tol)
            for field in ("params", "anchor", "anchor_grad"):
                assert_tree_close(getattr(tstate, field), np_tree(getattr(jstate, field)), tol,
                                  f"round {r} {field}")
        assert tstate.step == 3
        return
    kw = dict(local_lr=0.2, local_steps=2)
    if algo == "fedavg":
        jstate, tstate = jdeep.FedAvgState(jparams, jnp.zeros((), jnp.int32)), \
            tdeep.FedAvgState(tparams, 0)
        jround = jax.jit(lambda s, b: jdeep.fedavg_round(jloss, s, b, **kw))
        tround = tdeep.fedavg_round
    else:
        jstate, tstate = jdeep.deep_scaffold_init(jparams), tdeep.deep_scaffold_init(tparams)
        jround = jax.jit(lambda s, b: jdeep.deep_scaffold_round(jloss, s, b, **kw))
        tround = tdeep.deep_scaffold_round
    for r in range(2):
        jstate, jl = jround(jstate, jax_batch(batch))
        tstate, tl = tround(tloss, tstate, torch_batch(batch), **kw)
        np.testing.assert_allclose(tl.item(), float(jl), **tol)
        for field in tstate._fields:
            if field != "step":
                assert_tree_close(getattr(tstate, field), np_tree(getattr(jstate, field)), tol,
                                  f"round {r} {field}")


# ------------------------------------------------------------------ (f)
def test_train_step_trains():
    """The reference test's property (tests/test_launch.py:71-91): 10 rounds
    on C = 4 cohorts, eta 0.5, lr 0.2, K = 3, p 0.5, native coins, and the
    loss falls below 0.7 of its first value."""
    _, tcfg = qwen2_configs()
    svrp = tdeep.DeepSVRPConfig(eta=0.5, local_lr=0.2, local_steps=3, anchor_prob=0.5)
    step, helpers = make_svrp_train_step(tcfg, svrp, cohorts=4, device="cpu")
    state = helpers["init_state"](torch.Generator().manual_seed(0))
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (8, 32))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < 0.7 * losses[0], losses


@pytest.mark.parametrize("mode", ["exact", "reuse_local"])
def test_train_step_leaves_its_input_state_alone(mode):
    """The step returns a new state and writes into none of its input's
    tensors, also with K = 0 (y is x) in float32 over two cohorts; K = 0
    gives x' = x, and "reuse_local" refreshes gbar with the anchor gradient."""
    _, tcfg = qwen2_configs()
    svrp = tdeep.DeepSVRPConfig(eta=0.5, local_lr=0.2, local_steps=0, refresh_grad_mode=mode)
    step, helpers = make_svrp_train_step(tcfg, svrp, cohorts=2, device="cpu")
    state = helpers["init_state"](torch.Generator().manual_seed(0))
    before = tree_map(torch.clone, state.params)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (4, 8))
    new, _ = step(state, {"tokens": toks, "labels": toks}, refresh=True)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), state.params, before)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), new.params, before)
    assert new.anchor is new.params


# ------------------------------------------------------------------ (g)
def test_data_equals_reference():
    kw = dict(vocab_size=300, num_clients=3, alpha=0.5, seed=4)
    jds, tds = JDataset(**kw), SyntheticLMDataset(**kw)
    for name in ("emit", "ctx", "mix"):
        np.testing.assert_array_equal(getattr(tds, name), getattr(jds, name))
    jb = JBatcher(jds, num_cohorts=3, per_cohort_batch=2, seq_len=9)
    tb = ShardedBatcher(tds, num_cohorts=3, per_cohort_batch=2, seq_len=9)
    for _ in range(2):
        want, got = jb.next_batch(), tb.next_batch()
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype and got[k].shape == (6, 9)
    for a, b in zip(client_partition(100, 4, 0.3, seed=2), jclient_partition(100, 4, 0.3, seed=2)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ (h)
def test_train_launcher_runs(capsys, tmp_path):
    losses = train_main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--rounds", "2",
                         "--cohorts", "2", "--per-cohort-batch", "2", "--seq-len", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "2 client cohorts" in capsys.readouterr().out
    # --ckpt-dir, ported since: a checkpoint every round (tests/test_torch_checkpoint.py
    # restores them)
    train_main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--rounds", "2",
                "--cohorts", "1", "--per-cohort-batch", "1", "--seq-len", "8",
                "--local-steps", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000001.npz", "ckpt_00000002.npz"]
    # The flat-vector DeepSVRP driver, ported since, runs one trial.
    from repro_torch.problems import make_synthetic_quadratic

    q = make_synthetic_quadratic(4, 3, L=10.0, delta=1.0, seed=0, device="cpu")
    res = tdeep.run_deep_svrp(q, torch.zeros(3, dtype=torch.float64), q.minimizer(), eta=0.1,
                              local_lr=0.05, anchor_prob=0.5, num_steps=5, seed=0, device="cpu")
    assert res.dist_sq.shape == (5,) and float(res.dist_sq[-1]) < float(res.dist_sq[0])


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_train_launcher_runs_the_recurrent_families(capsys, arch):
    """launch/train.py --reduced on the hybrid and ssm families: one round
    (the scans' gradients through the plain K6b and K7b)."""
    losses = train_main(["--arch", arch, "--reduced", "--device", "cpu", "--rounds", "1",
                         "--cohorts", "1", "--per-cohort-batch", "2", "--seq-len", "16",
                         "--local-steps", "2"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert f"{arch} on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b", "rwkv6-1.6b"])
def test_state_converters_follow_the_family(name):
    """`convert.svrp_state_from_numpy` and `adamw_state_from_numpy` on each
    ported family's reduced bf16 tree (seeded values in the shapes and dtypes
    the reference's `init_params` gives, read by `eval_shape`): every leaf in
    the dtype the port's `init_params` gives it (the hybrid's A_log, D and
    dt_bias and the ssm's w0 and u stay float32), gbar and the moments in
    float32, the values the reference's."""
    from repro import optim as jopt
    from repro.configs import REGISTRY as JREG
    from repro_torch.configs import REGISTRY as TREG

    jcfg, tcfg = JREG[name].reduced(), TREG[name].reduced()
    assert tcfg.param_dtype == "bfloat16"
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k), jax.random.key(0))
    jparams = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), shapes)
    tree = np_tree(jparams)
    gbar = jax.tree.map(lambda a: a * np.float32(0.5), tree)
    want = TM.init_params(tcfg, torch.Generator(), device="meta")
    exact = dict(rtol=0, atol=0)

    def same_dtypes(got, like, dtype=None):
        tree_map(lambda g, w: None if g.dtype == (dtype or w.dtype) else pytest.fail(
            f"{name}: {g.dtype} where {dtype or w.dtype}"), got, like)

    state = convert.svrp_state_from_numpy({"params": tree, "anchor": tree, "anchor_grad": gbar,
                                           "step": 3}, tcfg, device="cpu")
    assert state.step == 3
    for field, ref in (("params", tree), ("anchor", tree), ("anchor_grad", gbar)):
        got = getattr(state, field)
        same_dtypes(got, want, torch.float32 if field == "anchor_grad" else None)
        assert_tree_close(got, ref, exact, f"{name} {field}")
    jstate = jax.tree.map(np.asarray, {"params": jparams, "opt": jopt.adamw_init(jparams)})
    adamw = convert.adamw_state_from_numpy(jstate, tcfg, device="cpu")
    same_dtypes(adamw.params, want)
    same_dtypes(adamw.opt.mu, want, torch.float32)
    same_dtypes(adamw.opt.nu, want, torch.float32)
    assert_tree_close(adamw.params, tree, exact, f"{name} adamw params")
    assert adamw.opt.step == 0


# ------------------------------------------------------------------ (i)
def test_unbind_forward_equals_per_layer_selects():
    """The forward takes its layers from one unbind per leaf: serving's
    logits are bit-identical to the per-layer ``t[i]`` views it took
    before, and so is the gradient."""
    _, tcfg = qwen2_configs()
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 11)))

    def select_forward(p):
        from repro_torch.models import layers as nn

        x = nn.embed_apply(p["embed"], tokens)
        rope = nn.rope_tables(torch.arange(11), tcfg.head_dim, tcfg.rope_theta)
        for i in range(tcfg.num_layers):
            x = transformer._layer_apply(tree_map(lambda t: t[i], p["layers"]), tcfg, x, rope)
        return nn.unembed_apply(p["head"], nn.rmsnorm_apply(p["ln_f"], x, tcfg.norm_eps))

    with torch.no_grad():
        assert torch.equal(transformer.dense_forward(params, tcfg, tokens), select_forward(params))
    loss = lambda f: lambda p, _: f(p).square().mean()  # noqa: E731
    _, g_unbind = value_and_grad(loss(lambda p: transformer.dense_forward(p, tcfg, tokens)),
                                 params, None)
    _, g_select = value_and_grad(loss(select_forward), params, None)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), g_unbind, g_select)
