"""The port's hybrid family (zamba2: `repro_torch.models.ssm`,
`repro_torch.models.hybrid`) against `repro`, on the CPU.

The reference's weights (drawn with its jax keys) cross into the port as
numpy arrays (`convert.hybrid_params_from_numpy`).  At init the LoRA ``b``
matrices and ``conv_b`` are zeros and ``D`` is ones, so a wrongly wired LoRA
or conv bias would add exactly zero: every comparison first fills them with
seeded random values (LoRA ``b`` normal * rank**-0.5, ``conv_b`` normal *
0.1, ``D`` normal), in both packages alike.  On the CPU the port's scan and
attention are the plain versions of K6, K4 and K5; the reference runs its
default chunked jnp path.

Two model shapes: the reduced zamba2 (2 layer slots, one Mamba-2 layer and
one attention site, 4 SSM heads of P 128, N 16, LoRA rank 8) and the same
with 6 slots every 3rd an attention site (2 groups of 2 Mamba-2 layers), so
the per-group stacks and the per-site LoRA are indexed past 0.

Tolerances: float32 rtol = atol = 1e-4, as tests/test_torch_models.py (the
summation order of products and scans differs, ~1e-6 relative a layer).
bfloat16: one Mamba-2 layer rtol = atol = 5e-2 (both packages round every
product to bfloat16, not always at the same place); the model's logits
and caches within 5e-2 in relative L2.  Element by element the whole model does not
meet 5e-2: on these inputs each package's bf16 logits lie 1.6% (reduced)
and 2.8-3.1% (two groups) in L2 from the float32 evaluation of the same
weights, and single logits of magnitude up to ~5 differ by up to 0.21 from
that evaluation in either package, so the port is as far from the reference
as each is from float32.  Prefill against teacher-forced decode in float32
(the chunked scan against the one-step recurrence): 1e-4.
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
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    BatchServer,
    ServeConfig,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

NAME = "zamba2-2.7b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BF16_REL_L2 = 5e-2
VARIANTS = {"reduced": {}, "two_groups": dict(num_layers=6, attn_every=3)}
PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [11, 3, 12, 13, 14]]  # ragged, 5 requests


def _configs(dtype, **extra):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **extra)
    return (dataclasses.replace(JAX_REGISTRY[NAME].reduced(), **kw),
            dataclasses.replace(REGISTRY[NAME].reduced(), **kw))


def _models(dtype, variant="reduced", seed=0):
    jcfg, tcfg = _configs(dtype, **VARIANTS[variant])
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(seed)))
    tree = randomize_recurrent(tree, "hybrid", seed + 100)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, convert.hybrid_params_from_numpy(tree, tcfg, device="cpu")


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
    flash_attention.launches = decode_attention.launches = ssm_scan.launches = 0
    yield
    # CPU: plain versions only
    assert flash_attention.launches == decode_attention.launches == ssm_scan.launches == 0


# ------------------------------------------------------------------- config
def test_hybrid_config_is_the_reference():
    cfg = get_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_REGISTRY[NAME])
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(JAX_REGISTRY[NAME].reduced())
    assert cfg.param_count() == JAX_REGISTRY[NAME].param_count()
    assert tssm.mamba_dims(cfg) == jssm.mamba_dims(JAX_REGISTRY[NAME]) == (5120, 80, 64, 64)
    small = cfg.reduced()
    assert (small.num_layers, small.attn_every, small.hybrid_lora_rank) == (2, 2, 8)
    assert tssm.mamba_dims(small) == (512, 4, 128, 16)


# -------------------------------------------------------------------- layer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_layer_matches_reference(dtype):
    """One Mamba-2 layer: the full-sequence apply (the scan over 150 steps,
    off the chunk), then token-by-token decode from a zero state, its output
    and its conv and SSM states at every step."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, jparams, tcfg, tparams = _models(dtype)
    jp = jax.tree.map(lambda a: a[0, 0], jparams["mamba_layers"])
    tp = tree_map(lambda t: t[0, 0], tparams["mamba_layers"])
    x = np.random.default_rng(1).standard_normal((2, 150, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_allclose(_np(tssm.mamba_apply(tp, tcfg, tx)),
                               _np(jssm.mamba_apply(jp, jcfg, jx)), **tol)

    jstep = jax.jit(lambda p, x, s: jssm.mamba_decode_step(p, jcfg, x, s))
    jstate = jssm.mamba_state_init(jcfg, 2)
    tstate = tssm.mamba_state_init(tcfg, 2)
    for t in range(12):
        want, jstate = jstep(jp, jx[:, t:t + 1], jstate)
        got, tstate2 = tssm.mamba_decode_step(tp, tcfg, tx[:, t:t + 1], tstate)
        assert tstate2 is tstate  # written in place
        np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=f"step {t}")
        for k in ("conv", "ssm"):
            assert tstate[k].dtype == torch.float32
            np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), **tol,
                                       err_msg=f"{k} state, step {t}")


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_decode_match_reference(variant, dtype):
    """Full-sequence logits (the scan off its chunk at 70 tokens), the loss,
    and every decode step's logits and the final cache (Mamba-2 states and
    KV) against `repro.models.model`."""
    jcfg, jparams, tcfg, tparams = _models(dtype, variant)
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

    steps = 20
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 2, 24, dtype=jnp.float32)
    tcache = TM.init_decode_cache(tcfg, 2, 24, dtype=torch.float32, device="cpu")
    for t in range(steps):
        jl_t, jcache = jstep(jparams, jbatch["tokens"][:, t], jcache, t)
        tl_t, tcache = TM.decode_step(tparams, tcfg, tbatch["tokens"][:, t], tcache, t)
        _assert_model_close(tl_t, jl_t, dtype, f"step {t}")
    for k in ("k", "v"):
        _assert_model_close(tcache[k], jcache[k], dtype, f"{k} cache")
    for k in ("conv", "ssm"):
        assert tcache["mamba"][k].shape == jcache["mamba"][k].shape
        _assert_model_close(tcache["mamba"][k], jcache["mamba"][k], dtype, f"{k} state")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_agrees_with_teacher_forced_decode(variant):
    """The two paths through the Mamba-2 layers: the prefill step (the chunked
    scan, K6's path) and teacher-forced decode (the one-step recurrence,
    `BatchServer`'s path) give the same last-position logits over 150 tokens."""
    _, _, tcfg, tparams = _models("float32", variant)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (3, 150)))
    prefill = make_prefill_step(tcfg, device="cpu")(tparams, {"tokens": tokens})
    step = make_serve_step(tcfg, device="cpu")
    cache = TM.init_decode_cache(tcfg, 3, 160, dtype=torch.float32, device="cpu")
    for t in range(150):
        logits, cache = step(tparams, cache, tokens[:, t], t)
    torch.testing.assert_close(logits, prefill, **F32_TOL)


# --------------------------------------------------------------- conversion
def test_convert_keeps_each_leafs_dtype_and_checks_the_tree():
    jcfg, jparams, tcfg, tparams = _models("bfloat16", "two_groups")
    mamba = tparams["mamba_layers"]
    for k in ("A_log", "D", "dt_bias"):  # float32 in a bf16 model, as the reference's
        assert str(jparams["mamba_layers"][k].dtype) == "float32"
        assert mamba[k].dtype == torch.float32
    assert mamba["in_proj"]["w"].dtype == mamba["conv_w"].dtype == torch.bfloat16
    assert tparams["loras"]["q"]["b"].dtype == tparams["embed"]["emb"].dtype == torch.bfloat16
    G, per_group = 2, 2
    assert mamba["conv_b"].shape == (G, per_group, 512 + 2 * 16)
    assert tparams["loras"]["o"]["a"].shape == (G, tcfg.num_heads * tcfg.head_dim, 8)
    np.testing.assert_array_equal(_np(mamba["D"]), _np(jparams["mamba_layers"]["D"]))
    want = TM.init_params(tcfg, torch.Generator(), device="meta")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, tparams))

    tree = jax.tree.map(np.asarray, jparams)
    del tree["loras"]["v"]
    with pytest.raises(ValueError, match="expected keys"):
        convert.hybrid_params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["mamba_layers"]["A_log"] = tree["mamba_layers"]["A_log"][:1]
    with pytest.raises(ValueError, match="expected shape"):
        convert.hybrid_params_from_numpy(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="hybrid family"):
        convert.dense_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


# ------------------------------------------------------------------ serving
def test_greedy_tokens_equal_reference():
    """Ragged prompts, max_batch (2) below the number of requests (5), the
    reference's default float32 cache: `BatchServer` on the reduced zamba2
    with two groups, float32, against `repro.launch.serve`."""
    jcfg, jparams, tcfg, tparams = _models("float32", "two_groups")
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
    cache = TM.init_decode_cache(tcfg, 3, 16, dtype=torch.float32, device="cpu")
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 3, 16, dtype=jnp.float32)
    for t in range(9):
        logits, cache = step(tparams, cache, tokens[:, t], t)
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t], jnp.int32), jcache, t)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32_TOL)


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
    `SSMScan`: K6 and K6b on the card, their plain versions here; attention's
    through `FlashAttention`) against the
    reference's on a 1 x 1 debug mesh, 2 rounds with its coins injected,
    from the randomised weights: x, w, gbar and the loss at rtol 1e-4."""
    jcfg, jparams, tcfg, _ = _models("float32")
    deep_step_matches_reference(jcfg, tcfg, np_tree(jparams))
