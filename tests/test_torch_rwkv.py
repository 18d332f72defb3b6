"""The port's ssm family (rwkv6: `repro_torch.models.rwkv`) against `repro`,
on the CPU.

The reference's weights (drawn with its jax keys) cross into the port as
numpy arrays (`convert.ssm_params_from_numpy`).  At init every time-mix
layer has ``w0 = -4`` for every channel and ``w_b`` scaled by 0.01, so the
decay is nearly one constant and a fault in the data-dependent decay's
wiring would hardly show; ``u`` is 0.1 N(0, 1), which makes a dropped bonus
small.  So every comparison first fills them, in both packages alike:
``w0`` uniform in [-6, 1] (decays from 0.9975 down to 0.066), ``w_b``
normal * 64**-0.5 and ``u`` N(0, 1).  On the CPU the port's scan is the
plain version of K7; the reference runs its oracle `ref.rwkv6_scan`.

Tolerances: float32 rtol = atol = 1e-4, as tests/test_torch_hybrid.py (the
summation order of the products differs, ~1e-6 relative a layer).
bfloat16: one layer rtol = atol = 5e-2 element by element (both packages
round every product to bfloat16, not always at the same place); the
model's logits and states within 5e-2 in relative L2, as the hybrid tests
hold them (on these inputs the two packages' bf16 logits differ by ~1.5%
in relative L2, as far as each lies from the float32 evaluation).  Prefill
against teacher-forced decode in float32 (the scan over the sequence
against the scan one step at a time from the carried state): 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import (  # noqa: E402
    deep_step_matches_reference,
    np_tree,
    randomize_recurrent,
)
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.launch.serve import BatchServer as JaxServer  # noqa: E402
from repro.launch.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    BatchServer,
    ServeConfig,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

NAME = "rwkv6-1.6b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BF16_REL_L2 = 5e-2
# the ssm config of tests/test_serve.py:61-70: d 64, 4 heads of K 16, d_ff 128, vocab 64
SERVE_VARIANT = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                     d_ff=128)
PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [11, 3, 12, 13, 14]]  # ragged, 5 requests


def _configs(dtype, **extra):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **extra)
    return (dataclasses.replace(JAX_REGISTRY[NAME].reduced(), **kw),
            dataclasses.replace(REGISTRY[NAME].reduced(), **kw))


def _models(dtype, seed=0, **extra):
    jcfg, tcfg = _configs(dtype, **extra)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    tree = randomize_recurrent(tree, "ssm", seed + 100)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, convert.ssm_params_from_numpy(tree, tcfg, device="cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _assert_model_close(got, want, dtype, what=""):
    """float32: element by element at F32_TOL; bfloat16: relative L2."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_L2, f"{what}: relative L2 {rel} > {BF16_REL_L2}"


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    rwkv6_scan.launches = 0
    yield
    assert rwkv6_scan.launches == 0  # CPU: the plain version only


# ------------------------------------------------------------------- config
def test_rwkv_config_is_the_reference():
    cfg = get_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_REGISTRY[NAME])
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(JAX_REGISTRY[NAME].reduced())
    assert trwkv.rwkv_dims(cfg) == jrwkv.rwkv_dims(JAX_REGISTRY[NAME]) == (32, 64)
    small = cfg.reduced()
    assert (small.num_layers, small.d_model, small.d_ff, small.vocab_size) == (2, 256, 512, 512)
    assert trwkv.rwkv_dims(small) == (4, 64)
    # every leaf at full size, as `jax.eval_shape` counts the reference's
    full = TM.init_params(cfg, torch.Generator(), device="meta")
    leaves = jax.tree.leaves(full)
    assert sum(t.numel() for t in leaves) == 1_583_941_632
    tm = full["layers"]["tm"]
    assert tm["w0"].shape == (24, 2048) and tm["w0"].dtype == torch.float32
    assert tm["u"].shape == (24, 32, 64) and tm["u"].dtype == torch.float32
    assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32}
    assert sum(t.dtype == torch.float32 for t in leaves) == 2


# -------------------------------------------------------------------- layer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timemix_and_channelmix_match_reference(dtype):
    """One layer's time-mix and channel-mix blocks: the full-sequence apply
    over 70 steps (off K7's 32-step tile), then the decode form token by
    token from zero states, its output and its carried shift and WKV states
    at every step."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, jparams, tcfg, tparams = _models(dtype)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"])
    tp = tree_map(lambda t: t[1], tparams["layers"])
    x = np.random.default_rng(1).standard_normal((2, 70, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))

    jtm_step = jax.jit(lambda p, x, s, S: jrwkv.timemix_apply(p, jcfg, x, s, S))
    jcm_step = jax.jit(lambda p, x, s: jrwkv.channelmix_apply(p, jcfg, x, s))
    jout, jshift, jS = jtm_step(jp["tm"], jx, None, None)
    tout, tshift, tS = trwkv.timemix_apply(tp["tm"], tcfg, tx)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    np.testing.assert_allclose(_np(tshift), _np(jshift), **tol)
    assert tS.dtype == torch.float32
    _assert_model_close(tS, jS, dtype, "wkv state")
    jout, jshift = jcm_step(jp["cm"], jx, None)
    tout, tshift = trwkv.channelmix_apply(tp["cm"], tcfg, tx)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    np.testing.assert_allclose(_np(tshift), _np(jshift), **tol)

    H, K = trwkv.rwkv_dims(tcfg)
    f32 = np.zeros((2, 1, tcfg.d_model), np.float32)
    jtm = jcm = jnp.asarray(f32)
    jwkv = jnp.zeros((2, H, K, K), jnp.float32)
    ttm = tcm = torch.from_numpy(f32)
    twkv = torch.zeros((2, H, K, K))
    cdt = getattr(jnp, dtype)
    for t in range(12):
        jo, jtm_n, jwkv = jtm_step(jp["tm"], jx[:, t:t + 1], jtm.astype(cdt), jwkv)
        to, ttm_n, twkv = trwkv.timemix_apply(tp["tm"], tcfg, tx[:, t:t + 1], ttm.to(tx.dtype),
                                              twkv)
        jo, jcm_n = jcm_step(jp["cm"], jo, jcm.astype(cdt))
        to, tcm_n = trwkv.channelmix_apply(tp["cm"], tcfg, to, tcm.to(tx.dtype))
        jtm, jcm = jtm_n.astype(jnp.float32), jcm_n.astype(jnp.float32)
        ttm, tcm = ttm_n.float(), tcm_n.float()
        np.testing.assert_allclose(_np(to), _np(jo), **tol, err_msg=f"step {t}")
        np.testing.assert_allclose(ttm.numpy(), np.asarray(jtm), **tol, err_msg=f"step {t}")
        np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), **tol, err_msg=f"step {t}")
        _assert_model_close(twkv, jwkv, dtype, f"wkv state, step {t}")


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_decode_match_reference(dtype):
    """Full-sequence logits over 70 tokens, the loss, and every decode step's
    logits and the final state (shift states and WKV) against
    `repro.models.model`."""
    jcfg, jparams, tcfg, tparams = _models(dtype)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 70))
    labels = rng.integers(-1, tcfg.vocab_size, (2, 70))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}

    jlogits, _ = JM.forward(jparams, jcfg, jbatch)
    tlogits, aux = TM.forward(tparams, tcfg, tbatch)
    assert tlogits.shape == (2, 70, tcfg.vocab_size) and tlogits.dtype == getattr(torch, dtype)
    assert aux.item() == 0.0
    _assert_model_close(tlogits, jlogits, dtype, "forward")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(TM.loss_fn(tparams, tcfg, tbatch).item(),
                               float(JM.loss_fn(jparams, jcfg, jbatch)), **tol)

    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 2, 24)
    tcache = TM.init_decode_cache(tcfg, 2, 24, device="cpu")
    for t in range(20):
        jl_t, jcache = jstep(jparams, jbatch["tokens"][:, t], jcache, t)
        tl_t, tcache2 = TM.decode_step(tparams, tcfg, tbatch["tokens"][:, t], tcache, t)
        assert tcache2 is tcache  # written in place
        _assert_model_close(tl_t, jl_t, dtype, f"step {t}")
    for k in ("tm_shift", "cm_shift", "wkv"):
        assert tcache[k].shape == jcache[k].shape and tcache[k].dtype == torch.float32
        _assert_model_close(tcache[k], jcache[k], dtype, f"{k} state")


def test_prefill_agrees_with_teacher_forced_decode():
    """The two paths through K7: the prefill step (the scan over 150 tokens)
    and teacher-forced decode (the scan one step at a time from the carried
    state, `BatchServer`'s path) give the same last-position logits."""
    _, _, tcfg, tparams = _models("float32")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (3, 150)))
    prefill = make_prefill_step(tcfg, device="cpu")(tparams, {"tokens": tokens})
    step = make_serve_step(tcfg, device="cpu")
    cache = TM.init_decode_cache(tcfg, 3, 8, device="cpu")  # cache_len does not bound the state
    for t in range(150):
        logits, cache = step(tparams, cache, tokens[:, t], t)
    torch.testing.assert_close(logits, prefill, **F32_TOL)


# --------------------------------------------------------------- conversion
def test_convert_keeps_each_leafs_dtype_and_checks_the_tree():
    jcfg, jparams, tcfg, tparams = _models("bfloat16")
    tm = tparams["layers"]["tm"]
    for k in ("w0", "u"):  # float32 in a bf16 model, as the reference's
        assert str(jparams["layers"]["tm"][k].dtype) == "float32"
        assert tm[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(tm[k]), _np(jparams["layers"]["tm"][k]))
    assert tm["mu"].dtype == tm["w_b"]["w"].dtype == torch.bfloat16
    assert tparams["layers"]["cm"]["wk"]["w"].dtype == tparams["embed"]["emb"].dtype
    assert tm["u"].shape == (2, 4, 64) and tm["mu"].shape == (2, 5, 256)
    want = TM.init_params(tcfg, torch.Generator(), device="meta")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, tparams))
    cache = TM.init_decode_cache(tcfg, 3, 100, dtype=torch.bfloat16, device="cpu")
    jcache = JM.init_decode_cache(jcfg, 3, 100)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == \
        {k: (v.shape, torch.float32) for k, v in jcache.items()}

    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"]["tm"]["w_a"]
    with pytest.raises(ValueError, match="expected keys"):
        convert.ssm_params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"]["tm"]["u"] = tree["layers"]["tm"]["u"][:, :1]
    with pytest.raises(ValueError, match="expected shape"):
        convert.ssm_params_from_numpy(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="ssm family"):
        convert.hybrid_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    zcfg = REGISTRY["zamba2-2.7b"].reduced()
    with pytest.raises(ValueError, match="hybrid family"):
        convert.ssm_params_from_numpy(jax.tree.map(np.asarray, jparams), zcfg, device="cpu")


# ------------------------------------------------------------------ serving
def test_greedy_tokens_equal_reference():
    """Ragged prompts, max_batch (2) below the number of requests (5): the
    ssm config of tests/test_serve.py (K 16) in float32, `BatchServer`
    against `repro.launch.serve`."""
    jcfg, jparams, tcfg, tparams = _models("float32", **SERVE_VARIANT)
    assert trwkv.rwkv_dims(tcfg) == (4, 16)
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=2, cache_len=32)).generate(
        PROMPTS, max_new_tokens=6)
    got = BatchServer(tcfg, tparams, ServeConfig(max_batch=2, cache_len=32),
                      device="cpu").generate(PROMPTS, max_new_tokens=6)
    assert got == want
    assert [len(o) for o in got] == [6] * 5


def test_prefill_and_serve_steps_match_reference():
    jcfg, jparams, tcfg, tparams = _models("float32")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 9))
    got = make_prefill_step(tcfg, device="cpu")(tparams, {"tokens": tokens})
    want = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})[0][:, -1]
    assert got.shape == (3, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)

    step = make_serve_step(tcfg, device="cpu")
    cache = TM.init_decode_cache(tcfg, 3, 16, device="cpu")
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 3, 16)
    for t in range(9):
        logits, cache = step(tparams, cache, tokens[:, t], t)
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t], jnp.int32), jcache, t)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32_TOL)
    np.testing.assert_allclose(cache["wkv"].numpy(), np.asarray(jcache["wkv"]), **F32_TOL)


def test_what_is_not_ported_is_refused():
    """A family the port has not taken (moe) by both train steps; the card
    by default when there is none."""
    from repro_torch.core.deep import DeepSVRPConfig
    from repro_torch.launch import make_adamw_train_step, make_svrp_train_step

    _, tcfg = _configs("float32")
    moe = dataclasses.replace(tcfg, family="moe")
    with pytest.raises(NotImplementedError, match="the moe family is not ported"):
        make_svrp_train_step(moe, DeepSVRPConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="the moe family is not ported"):
        make_adamw_train_step(moe, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_decode_cache(tcfg, 1, 8)


def test_train_step_one_cohort_matches_reference():
    """The DeepSVRP train step (one cohort, the scan's gradient through
    `RWKV6Scan`: K7 and K7b on the card, their plain versions here) against the
    reference's on a 1 x 1 debug mesh, 2 rounds with its coins injected,
    from the randomised weights: x, w, gbar and the loss at rtol 1e-4."""
    jcfg, jparams, tcfg, _ = _models("float32")
    deep_step_matches_reference(jcfg, tcfg, np_tree(jparams))
