"""The port's optimizers (`repro_torch.optim`) and AdamW train step
(`launch.make_adamw_train_step`) against `repro`, on the CPU.

The same numpy draws (seeded) go into both packages.  The elementwise
rules run 5 steps on a small tree of float32 or bfloat16 leaves: every
float32 result (moments, float32 parameters, the norm, the schedules) is
held to rtol 1e-6, every bfloat16 one (parameters, clipped gradients) to
one bfloat16 ulp of the reference's value: both packages compute in
float32 and round once, but XLA may contract a product and a sum into one
rounding.  The train step on the reduced qwen2 and llama3.2 in float32
runs 3 steps against the reference's step body composed from
`jax.value_and_grad(M.loss_fn)`, `clip_by_global_norm` and `adamw_update`
(the body of `repro.launch.steps.make_adamw_train_step`, without its mesh),
from the same state carried across by `convert.adamw_state_from_numpy`:
the loss rtol 1e-6; the gradient norm rtol 3e-6 (NORM_RTOL, from a float64
measurement) against the float64 norm of the reference's gradients, not
against the norm the reference reports:
XLA's CPU dot sums a float32 vdot in sequence, 1.4e-3 off over these
131,072-element leaves (torch's vdot 1e-8).  Each parameter leaf within
1e-5 in relative L2 (read: at most 2.3e-6), but for the biases (zeros at
init, so their values are the steps themselves): 1e-3, since the two
packages clip by scales that differ as their norms do, and Adam cancels a
common scale within a step but not across steps (read: 6.7e-5).  Not
element by element:
where a gradient element is as small as eps (1e-8), its summation-order
noise moves that element's Adam step (read: up to a tenth of lr on one
element of 131,072).  qwen2's key bias is held only to its step size:
its gradient is zero in exact arithmetic (a bias on the keys adds the same
score to every key of a query, which the softmax cancels), so both
packages step it by rounding noise that Adam scales up to lr.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import randomize_recurrent, reference_params  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data import ShardedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.launch import make_adamw_train_step  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

F32_RTOL = 1e-6
# The gradient norm the port's step reports (float32 sums, on one thread)
# against the float64 norm of the reference's float32 gradients, for every
# family.  Measured against both packages run in float64
# (tests/measure_f32_drift.py): the port's reported norm lies at most
# 1.18e-6 from the float64 run (zamba2; rwkv6 9.2e-7), the reference's
# gradients' norm at most 1.34e-6 (zamba2; rwkv6 5.0e-7), so the two lie
# within 2.52e-6 of each other.  The port's own gradients are no further
# from float64 than the reference's in any family (their float64 norms:
# 1.5e-7 against 1.3e-6 at most), and the reference's own float32 norm is
# 1.3e-3 to 2.1e-3 off: the gap is float32 summation order.
NORM_RTOL = 3e-6
KEY_BIAS = ("layers", "attn", "wk", "b")
BIAS_REL = 1e-3
SHAPES = {"a": (7, 5), "blk": {"b": (13,), "c": (3, 4, 2)}}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model's ops are tiny, and with several
    test processes on the host torch's thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_launches_nothing():
    flash_attention.launches = flash_attention_bwd.launches = 0
    yield
    assert flash_attention.launches == flash_attention_bwd.launches == 0


def _draw(rng, scale=1.0):
    def leaf(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def walk(s):
        return {k: walk(v) for k, v in s.items()} if isinstance(s, dict) else leaf(s)

    return walk(SHAPES)


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _torch(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, path + (k,))]
    return [(path, tree)]


def _assert_close(got, want, what):
    """Leaf by leaf: float32 at F32_RTOL, bfloat16 within one ulp of ``want``."""
    for g, w in zip(_leaves(got), jax.tree.leaves(want), strict=True):
        assert str(g.dtype) == f"torch.{w.dtype}", what
        g32, w32 = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if w.dtype == jnp.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w32), 2.0**-126))) - 7)
            assert np.all(np.abs(g32 - w32) <= ulp), (what, np.max(np.abs(g32 - w32) / ulp))
        else:
            np.testing.assert_allclose(g32, w32, rtol=F32_RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype):
    """5 steps on the same gradients (each package's own leaves of the same
    values), lr 1e-2, weight decay 0.1: parameters and both moments."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    p0 = _draw(rng)
    jp, tp = _jax(p0, jdt), _torch(p0, tdt)
    jstate, tstate = jopt.adamw_init(jp), optim.adamw_init(tp)
    for t in range(5):
        g = _draw(rng, scale=10.0 ** -t)  # v's bias correction and eps both matter
        jp, jstate = jopt.adamw_update(_jax(g, jdt), jstate, jp, lr=1e-2)
        tp, tstate = optim.adamw_update(_torch(g, tdt), tstate, tp, lr=1e-2)
        _assert_close(tp, jp, f"step {t} params")
        _assert_close(tstate.mu, jstate.mu, f"step {t} mu")
        _assert_close(tstate.nu, jstate.nu, f"step {t} nu")
        assert tstate.step == int(jstate.step) == t + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgdm_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    p0 = _draw(rng)
    jp, tp = _jax(p0, jdt), _torch(p0, tdt)
    jstate, tstate = jopt.sgdm_init(jp), optim.sgdm_init(tp)
    for t in range(5):
        g = _draw(rng)
        jp, jstate = jopt.sgdm_update(_jax(g, jdt), jstate, jp, lr=0.05, beta=0.9)
        tp, tstate = optim.sgdm_update(_torch(g, tdt), tstate, tp, lr=0.05, beta=0.9)
        _assert_close(tp, jp, f"step {t} params")
        _assert_close(tstate.momentum, jstate.momentum, f"step {t} momentum")
        assert tstate.step == int(jstate.step) == t + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(dtype):
    """Five gradient trees, norms from ~0.1 to ~100 around max_norm 2: the
    clipped leaves and the norm, in the leaves' dtype (each leaf's vdot in
    its own dtype, summed from the reference's weakly typed zero)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    for scale in (0.01, 0.1, 1.0, 3.0, 10.0):
        g = _draw(rng, scale)
        jg, jnorm = jopt.clip_by_global_norm(_jax(g, jdt), 2.0)
        tg, tnorm = optim.clip_by_global_norm(_torch(g, tdt), 2.0)
        _assert_close(tg, jg, f"scale {scale}")
        assert str(tnorm.dtype) == f"torch.{jnorm.dtype}"
        np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=F32_RTOL)
    below = _torch(_draw(rng, 0.01), tdt)
    clipped, _ = optim.clip_by_global_norm(below, 2.0)
    for a, b in zip(_leaves(clipped), _leaves(below)):
        assert torch.equal(a, b)  # below the limit: untouched


def test_schedules_match_reference():
    """Both schedules at every step 0..12, through and past the warm-up and
    the horizon; ints and integer tensors as the step."""
    kw = dict(base_lr=3e-4, total_steps=10)
    for s in range(13):
        want = float(jopt.cosine_schedule(jnp.asarray(s), **kw, final_frac=0.2))
        for step in (s, torch.tensor(s)):
            got = optim.cosine_schedule(step, **kw, final_frac=0.2)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), want, rtol=F32_RTOL)
        want = float(jopt.linear_warmup_cosine(jnp.asarray(s), base_lr=1.0, warmup=4,
                                               total_steps=10))
        got = optim.linear_warmup_cosine(s, base_lr=1.0, warmup=4, total_steps=10)
        np.testing.assert_allclose(got.item(), want, rtol=F32_RTOL)


def test_adamw_optimizes_quadratic():
    """The reference test's property (tests/test_data_optim_ckpt.py)."""
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.adamw_init(params)
    for _ in range(300):
        params, state = optim.adamw_update({"w": 2 * params["w"]}, state, params, lr=0.1,
                                           weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-4 and state.step == 300


def _configs(name):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(JAX_REGISTRY[name].reduced(), **kw),
            dataclasses.replace(REGISTRY[name].reduced(), **kw))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "llama3.2-3b", "zamba2-2.7b", "rwkv6-1.6b"])
def test_adamw_train_step_matches_reference(name):
    """3 steps over 3 batches of the synthetic federated data (2 x 16
    tokens), lr 3e-4, clip 1.0: the loss, the gradient norm (clipping
    active) and every parameter after each step.  The hybrid and ssm
    families (their scans' gradients through `SSMScan` and `RWKV6Scan`) from
    weights whose zeros and ones are randomised (`randomize_recurrent`)."""
    jcfg, tcfg = _configs(name)
    lr, clip = 3e-4, 1.0

    @jax.jit
    def jstep(state, batch):  # the body of repro.launch.steps.make_adamw_train_step
        loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(p, jcfg, batch))(state["params"])
        exact = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float64) ** 2) for g in jax.tree.leaves(grads)))
        grads, gnorm = jopt.clip_by_global_norm(grads, clip)
        params, opt = jopt.adamw_update(grads, state["opt"], state["params"], lr=lr)
        return {"params": params, "opt": opt}, loss, gnorm, exact

    if tcfg.family == "dense":
        jparams = JM.init_params(jcfg, jax.random.key(0))
    else:
        tree = randomize_recurrent(reference_params(jcfg), tcfg.family, 100)
        jparams = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    tstate = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    step, _ = make_adamw_train_step(tcfg, lr=lr, clip=clip, device="cpu")
    ds = JDataset(vocab_size=tcfg.vocab_size, num_clients=1, alpha=0.5, seed=0)
    batcher = JBatcher(ds, num_cohorts=1, per_cohort_batch=2, seq_len=16)
    for t in range(3):
        batch = batcher.next_batch()
        jstate, jloss, jnorm, jexact = jstep(jstate, {k: jnp.asarray(v)
                                                      for k, v in batch.items()})
        tstate, metrics = step(tstate, batch)
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jexact), rtol=NORM_RTOL)
        assert float(jnorm) > clip  # the clip acts
        want = jax.tree.map(np.asarray, jstate["params"])
        for path, got in _paths(tstate.params):
            ref = want
            for k in path:
                ref = ref[k]
            if path == KEY_BIAS:  # its steps are rounding noise: up to lr each
                assert np.max(np.abs(got.numpy() - ref)) <= 2 * lr * (t + 1), (t, path)
                continue
            rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
            assert rel <= (BIAS_REL if path[-1] == "b" else 1e-5), (t, path, rel)
        assert tstate.opt.step == t + 1


def test_adamw_step_refuses_an_unported_family():
    """Every family of the zoo is ported: an unknown one raises `ValueError`,
    as the reference's model table does."""
    unknown = dataclasses.replace(_configs("qwen2-1.5b")[1], family="vision")
    with pytest.raises(ValueError, match="unknown family vision"):
        make_adamw_train_step(unknown, device="cpu")
