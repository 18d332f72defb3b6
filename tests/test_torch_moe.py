"""The port's moe family (`repro_torch.models.moe`) against `repro`, on the CPU.

Two reduced configs in float32: deepseek-moe-16b (a dense first layer, one
MoE layer with 4 routed experts top-2 and 1 shared expert) and
qwen3-moe-235b-a22b (qk-norm, 4/1 heads, no shared experts, no dense
layer).  The reference's weights (drawn with its jax keys) cross as numpy
(`convert.moe_params_from_numpy`); the inputs come from numpy seeds.  On
the CPU the port's attention is the plain version of K4 and K5.

Tolerances.  The MoE MLP: output atol 1e-5 and aux 1e-6 against the
reference, the port's gather against its scatter 2e-5, gradients 5e-4
(tests/test_moe_dispatch.py's own).  The model (logits, aux, loss, its
gradient, decode steps): F32_TOL of tests/test_torch_models.py, rtol =
atol = 1e-4 (summation order only).  int8: the quantized trees bit for
bit.  Training: tests/test_torch_hybrid.py's (`deep_step_matches_reference`,
the AdamW step of tests/test_torch_optim.py).  Top-k ties: exact ids.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import (  # noqa: E402
    deep_step_matches_reference,
    np_tree,
    reference_params,
)
from repro import optim as jopt  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data import ShardedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.quant import quantize_params as ref_quantize_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import make_adamw_train_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.quant import quantize_params  # noqa: E402
from repro_torch.utils.tree import tree_map, value_and_grad  # noqa: E402

NAMES = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
MLP_TOL = dict(rtol=1e-5, atol=1e-5)
GATHER_SCATTER_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _configs(name, **extra):
    kw = dict(param_dtype="float32", compute_dtype="float32", **extra)
    return (dataclasses.replace(JAX_REGISTRY[name].reduced(), **kw),
            dataclasses.replace(REGISTRY[name].reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _reference_tree(name, **extra):
    """The reference's seed-0 weights for ``_configs(name, **extra)`` as numpy,
    drawn once for the module (its jitted init takes seconds a config); the
    tests copy before they change a tree."""
    return reference_params(_configs(name, **extra)[0], 0)


def _models(name, **extra):
    jcfg, tcfg = _configs(name, **extra)
    tree = _reference_tree(name, **extra)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, convert.moe_params_from_numpy(
        tree, tcfg, device="cpu")


def _t(tree):
    """A numpy / jax tree as float32 torch tensors."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), np_tree(tree))


def _assert_tree_close(got, want, tol, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], tol, f"{what}.{k}")
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=what)


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    flash_attention.launches = decode_attention.launches = 0
    yield
    assert flash_attention.launches == decode_attention.launches == 0  # CPU: plain versions only


# ------------------------------------------------------------------- configs
@pytest.mark.parametrize("name", NAMES)
def test_config_is_the_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(JAX_REGISTRY[name])
    assert (dataclasses.asdict(get_config(name).reduced())
            == dataclasses.asdict(JAX_REGISTRY[name].reduced()))
    assert get_config(name).param_count() == JAX_REGISTRY[name].param_count()
    assert get_config(name).active_param_count() == JAX_REGISTRY[name].active_param_count()


# ------------------------------------------------------------------ MoE MLP
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("name", NAMES)
def test_moe_mlp_matches_reference(name, capacity_factor):
    """Both dispatches at ample and dropping capacities: the output and aux
    against the reference's, the port's gather against its scatter, and the
    gradient of sum(y^2) + aux in every weight and in x."""
    _, base = _configs(name, capacity_factor=capacity_factor)
    jbase = dataclasses.replace(JAX_REGISTRY[name].reduced(), param_dtype="float32",
                                compute_dtype="float32", capacity_factor=capacity_factor)
    p = jmoe.moe_mlp_init(jax.random.key(3), jbase, jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 16, base.d_model)).astype(np.float32)
    modes = ("gather", "scatter")

    def jloss(pp, xx, mode):
        y, aux = jmoe.moe_mlp_apply(pp, dataclasses.replace(jbase, moe_dispatch=mode), xx)
        return jnp.sum(y**2) + aux, (y, aux)

    @jax.jit  # both dispatches in one program: one compile
    def jboth(pp, xx):
        return {mode: jax.value_and_grad(functools.partial(jloss, mode=mode), argnums=(0, 1),
                                         has_aux=True)(pp, xx) for mode in modes}

    want = jboth(p, jnp.asarray(x))
    got = {}
    for mode in modes:
        (_, (jy, jaux)), (jgp, jgx) = want[mode]
        tcfg = dataclasses.replace(base, moe_dispatch=mode)
        tp = tree_map(lambda t: t.requires_grad_(), _t(p))
        xt = torch.from_numpy(x).requires_grad_()
        ty, taux = tmoe.moe_mlp_apply(tp, tcfg, xt)
        (ty.pow(2).sum() + taux).backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **MLP_TOL, err_msg=mode)
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=0, atol=1e-6, err_msg=mode)
        _assert_tree_close(tree_map(lambda t: t.grad, tp), jgp, GRAD_TOL, mode)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL, err_msg=mode)
        got[mode] = ty.detach()
    np.testing.assert_allclose(got["gather"].numpy(), got["scatter"].numpy(),
                               **GATHER_SCATTER_TOL)


def test_top_k_breaks_ties_as_lax_top_k():
    """Probabilities with planted exact ties (values from 5 levels over 64
    experts), and a router whose columns repeat in pairs: the port's ids
    are ``lax.top_k``'s, lower expert first among equals; ``torch.topk``
    is not held to that order."""
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 5, (512, 64)).astype(np.float32) / 8.0
    for k in (1, 2, 6, 8):
        w, ids = tmoe.top_k(torch.from_numpy(probs), k)
        jw, jids = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    _, tcfg = _configs("deepseek-moe-16b", num_experts=8, num_experts_per_tok=3)
    half = rng.standard_normal((tcfg.d_model, 4)).astype(np.float32)
    router = np.repeat(half, 2, axis=1)  # experts 2i and 2i+1 always tie
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    probs_t, w, ids = tmoe.route({"w": torch.from_numpy(router)}, tcfg, torch.from_numpy(x))
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, jids = jax.lax.top_k(jprobs, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids[..., 0] % 2 == 0).all() and (ids[..., 1] == ids[..., 0] + 1).all()


def test_capacity_drops_and_weights_renormalise():
    """A capacity of 0.25 drops assignments (the output moves); the
    renormalised top-k weights sum to 1, and the experts stay in range."""
    _, tcfg = _configs("deepseek-moe-16b")
    p = tmoe.moe_mlp_init(torch.Generator().manual_seed(1), tcfg)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 32, tcfg.d_model))
                         .astype(np.float32))
    for mode in ("gather", "scatter"):
        cfg = dataclasses.replace(tcfg, moe_dispatch=mode)
        y_full, _ = tmoe.moe_mlp_apply(p, cfg, x, capacity_factor=8.0)
        y_low, _ = tmoe.moe_mlp_apply(p, cfg, x, capacity_factor=0.25)
        assert (y_full - y_low).abs().max().item() > 1e-6 and torch.isfinite(y_low).all()
    assert tmoe.capacity(tcfg, 32, 0.25) == 4 and tmoe.capacity(tcfg, 1, 1.25) == 1
    _, w, ids = tmoe.route(p["router"], tcfg, x)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert int(ids.max()) < tcfg.num_experts


# --------------------------------------------------------------------- model
@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_grad_and_decode_match_reference(name):
    """Full-sequence logits and aux, the loss (ce + 0.01 aux), its gradient
    in every weight against `jax.value_and_grad` of the reference's
    `loss_fn`, and 8 decode steps' logits and caches."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 12))
    labels = rng.integers(-1, tcfg.vocab_size, (2, 12))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}

    @jax.jit  # the forward and the loss's gradient in one program: one compile
    def jforward_and_grad(p):
        return JM.forward(p, jcfg, jbatch), jax.value_and_grad(
            lambda q: JM.loss_fn(q, jcfg, jbatch))(p)

    (jlogits, jaux), (jloss, jgrads) = jforward_and_grad(jparams)
    tlogits, taux = TM.forward(tparams, tcfg, tbatch)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **F32_TOL)
    assert taux.item() > 0.5  # the load-balance loss is carried

    tloss, tgrads = value_and_grad(lambda p, b: TM.loss_fn(p, tcfg, b), tparams, tbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), **F32_TOL)
    _assert_tree_close(tgrads, np_tree(jgrads), F32_TOL, "grad")

    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = TM.init_decode_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    assert set(tcache) == set(jcache)
    for t in range(8):
        jl_t, jcache = jstep(jparams, jbatch["tokens"][:, t], jcache, t)
        tl_t, tcache = TM.decode_step(tparams, tcfg, tbatch["tokens"][:, t], tcache, t)
        np.testing.assert_allclose(tl_t.numpy(), np.asarray(jl_t), **F32_TOL, err_msg=f"step {t}")
    _assert_tree_close(tcache, jax.tree.map(np.asarray, jcache), F32_TOL, "cache")


@pytest.mark.parametrize("name", NAMES)
def test_meta_init_and_convert_give_the_references_tree(name):
    """`init_params(device="meta")` has the reference's keys, shapes and
    dtypes at full size (32.75 GB for deepseek-moe-16b in bf16, nothing
    allocated), and the converter refuses a tree that is not the config's."""
    cfg = get_config(name)
    shapes = jax.eval_shape(lambda k: JM.init_params(JAX_REGISTRY[name], k), jax.random.key(0))
    meta = TM.init_params(cfg, torch.Generator(), device="meta")
    _assert_same_shapes(meta, shapes)
    jcfg, jparams, tcfg, _ = _models(name)
    tree = jax.tree.map(np.asarray, jparams)
    del tree["moe_layers"]["moe"]["router"]
    with pytest.raises(ValueError, match="expected keys"):
        convert.moe_params_from_numpy(tree, tcfg, device="cpu")


def _paths(tree, path=()):
    """(key path, leaf) of a torch tree, keys sorted at every level as
    `jax.tree.leaves` orders a dict's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree.detach()


def _assert_same_shapes(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_shapes(got[k], want[k], f"{path}/{k}")
    else:
        assert tuple(got.shape) == tuple(want.shape), path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path


# ---------------------------------------------------------------------- int8
def test_int8_tree_and_forward_match_reference():
    """The reduced deepseek with 64 experts top-6 (so the router, 256 x 64,
    is quantized too): `quantize_params` equal to the reference's bit for
    bit, the experts ``(L, E, d, ff)`` with a scale a column of each
    expert; the int8 model's logits against the reference's."""
    jcfg, jparams, tcfg, tparams = _models("deepseek-moe-16b", num_experts=64,
                                           num_experts_per_tok=6)
    jq = jax.tree.map(np.asarray, ref_quantize_params(jparams))
    tq = quantize_params(tparams)
    assert set(tq["moe_layers"]["moe"]["router"]["w"]) == {"q", "s"}
    n_moe = tcfg.num_layers - tcfg.first_dense_layers
    assert tq["moe_layers"]["moe"]["experts"]["up"]["w"]["s"].shape == (n_moe, 64, 1,
                                                                      tcfg.moe_d_ff)

    def same(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                same(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got.float().numpy() if got.dtype != torch.int8
                                          else got.numpy(), np.asarray(want, np.float32)
                                          if want.dtype != np.int8 else want, err_msg=path)

    same(tq, jq)
    tokens = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 10))
    jl, _ = jax.jit(lambda p: JM.forward(p, jcfg, {"tokens": jnp.asarray(tokens)}))(jq)
    tl, _ = TM.forward(tq, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


# ------------------------------------------------------------------ training
def test_train_step_one_cohort_matches_reference():
    """The DeepSVRP train step on the reduced deepseek (one cohort, 2 rounds
    with the reference's coins injected: a refresh and a plain round) against
    the reference's on a 1 x 1 debug mesh: x, w, gbar and the loss."""
    jcfg, tcfg = _configs("deepseek-moe-16b")
    deep_step_matches_reference(jcfg, tcfg, _reference_tree("deepseek-moe-16b"))


def test_adamw_train_step_matches_reference():
    """One AdamW step (lr 3e-4, clip 1.0 active) on the reduced qwen3-moe:
    the loss, the gradient norm and every parameter."""
    jcfg, jparams, tcfg, _ = _models("qwen3-moe-235b-a22b")
    lr, clip = 3e-4, 1.0
    batch = JBatcher(JDataset(vocab_size=tcfg.vocab_size, num_clients=1, alpha=0.5, seed=0),
                     num_cohorts=1, per_cohort_batch=2, seq_len=16).next_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jstep(params):  # the body of repro.launch.steps.make_adamw_train_step
        loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(p, jcfg, jb))(params)
        exact = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree.leaves(grads)))
        grads, _ = jopt.clip_by_global_norm(grads, clip)
        return loss, exact, jopt.adamw_update(grads, jopt.adamw_init(params), params, lr=lr)[0]

    loss, exact, want = jstep(jparams)
    state = convert.adamw_state_from_numpy(
        jax.tree.map(np.asarray, {"params": jparams, "opt": jopt.adamw_init(jparams)}), tcfg,
        device="cpu")
    step, _ = make_adamw_train_step(tcfg, lr=lr, clip=clip, device="cpu")
    state, metrics = step(state, batch)
    assert float(exact) > clip
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-6)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(exact), rtol=1e-5)
    # per leaf in relative L2, as tests/test_torch_optim.py: Adam amplifies
    # the summation order only at gradient elements as small as its eps
    for (path, got), ref in zip(_paths(state.params), jax.tree.leaves(np_tree(want))):
        rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 1e-5, (path, rel)


def test_fed_lm_loss_at_x0_matches_reference():
    """`FedLMProblem` over the reduced deepseek (3 clients of 2 x 16 tokens):
    x0 bit for bit, each client's loss and the metric at x0 (rtol 1e-5)."""
    from jax.flatten_util import ravel_pytree
    from repro.problems.fed_lm import FedLMProblem
    from repro_torch.problems.fed_lm import make_fed_lm_problem

    jcfg, tcfg = _configs("deepseek-moe-16b")
    tree = _reference_tree("deepseek-moe-16b")
    jx0, unravel = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    ds = JDataset(vocab_size=jcfg.vocab_size, num_clients=3, alpha=0.3, seed=0)
    toks = np.stack([ds.sample(m, 2, 16) for m in range(3)])
    jprob = FedLMProblem(tokens=jnp.asarray(toks[:, :, :-1], jnp.int32),
                         labels=jnp.asarray(toks[:, :, 1:], jnp.int32), cfg=jcfg,
                         unravel=unravel, num_params=int(jx0.size))
    tprob, _ = make_fed_lm_problem(tcfg, num_clients=3, per_client_batch=2, seq_len=16,
                                   alpha=0.3, seed=0, device="cpu")
    np.testing.assert_array_equal(tprob.tokens.numpy(), np.asarray(jprob.tokens))
    tx0 = convert.fed_lm_x0_from_numpy(tree, tcfg, device="cpu")
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(jx0))
    jloss = jax.jit(jprob.loss)
    for m in range(3):
        np.testing.assert_allclose(tprob.loss(torch.tensor(m), tx0).item(),
                                   float(jloss(jnp.asarray(m), jx0)), rtol=1e-5)
    np.testing.assert_allclose(tprob.metric(tx0).item(), float(jax.jit(jprob.metric)(jx0)),
                               rtol=1e-5)
