"""The port's dense model (`repro_torch.models`) against `repro.models`, on the CPU.

The reference's weights (drawn with its jax keys) cross into the port as
numpy arrays (`convert.dense_params_from_numpy` for a whole model), so both
packages compute on the same weights and the same numpy inputs.  On the CPU
the port's attention is the plain version of each kernel; the reference runs
its default chunked jnp path.

Tolerances: float32 rtol = atol = 1e-4 — only the summation order of the
products (contractions of at most 512 terms) and of the online softmax
differ, ~1e-6 relative per layer.  bfloat16 rtol = atol = 5e-2 on logits of
unit scale: both packages round every product and elementwise result to
bfloat16 (unit roundoff 2^-9 = 2e-3) but not always at the same place, and
a one-ulp difference in an intermediate moves the logits by a few ulps over
two layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, REGISTRY, get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DENSE = ["llama3.2-3b", "qwen2-1.5b", "qwen3-4b", "granite-3-2b"]


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, np.float32))
    return t.to(dtype or getattr(torch, str(tree.dtype)))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _configs(name, dtype):
    """The reference's and the port's reduced config of ``name`` in ``dtype``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(JAX_REGISTRY[name].reduced(), **kw),
            dataclasses.replace(REGISTRY[name].reduced(), **kw))


def _models(name, dtype, seed=0):
    jcfg, tcfg = _configs(name, dtype)
    jparams = JM.init_params(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, convert.dense_params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    flash_attention.launches = decode_attention.launches = 0
    yield
    assert flash_attention.launches == decode_attention.launches == 0  # CPU: plain versions only


# ------------------------------------------------------------------- configs
def test_configs_are_the_references():
    for name in DENSE + ["zamba2-2.7b", "rwkv6-1.6b"]:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(JAX_REGISTRY[name])
        assert (dataclasses.asdict(get_config(name).reduced())
                == dataclasses.asdict(JAX_REGISTRY[name].reduced()))
        assert get_config(name).param_count() == JAX_REGISTRY[name].param_count()
    assert get_config("llama3.2-3b").with_sliding_window(64).sliding_window == 64


def test_vlm_family_is_ported():
    """internvl2-76b's config is the reference's, and `init_params` on meta
    tensors has the reference's tree at full size: 70,647,032,960
    parameters (the decoder's and the projector's; nothing allocated),
    `param_count()` 70,552,387,584 as the reference's."""
    name = "internvl2-76b"
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(JAX_REGISTRY[name])
    assert (dataclasses.asdict(get_config(name).reduced())
            == dataclasses.asdict(JAX_REGISTRY[name].reduced()))
    assert get_config(name).param_count() == JAX_REGISTRY[name].param_count() == 70_552_387_584
    shapes = jax.eval_shape(lambda k: JM.init_params(JAX_REGISTRY[name], k), jax.random.key(0))
    meta = TM.init_params(get_config(name), torch.Generator(), device="meta")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, meta)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, shapes))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in jax.tree.leaves(meta)] == [
        (tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(shapes)]
    assert sum(t.numel() for t in jax.tree.leaves(meta)) == 70_647_032_960


def test_every_reference_architecture_is_ported():
    """The port's registry holds every architecture of the reference's, and
    an unknown name or family is refused as the reference refuses it
    (`KeyError`, `ValueError`)."""
    assert set(ARCH_IDS) == set(JAX_REGISTRY)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown family vision"):
        TM.init_params(dataclasses.replace(get_config("llama3.2-3b").reduced(), family="vision"),
                       device="cpu")


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "deepseek-moe-16b"])
def test_moe_family_is_ported(name):
    """The moe configs are the reference's, and `init_params` on meta
    tensors has the reference's tree at full size (nothing allocated)."""
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(JAX_REGISTRY[name])
    shapes = jax.eval_shape(lambda k: JM.init_params(JAX_REGISTRY[name], k), jax.random.key(0))
    meta = TM.init_params(get_config(name), torch.Generator(), device="meta")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, meta)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, shapes))
    assert [tuple(t.shape) for t in jax.tree.leaves(meta)] == [
        tuple(s.shape) for s in jax.tree.leaves(shapes)]


def test_audio_family_is_ported():
    """seamless-m4t-large-v2's config is the reference's, and `init_params`
    on meta tensors has the reference's tree at full size, 2,034,784,256
    parameters (nothing allocated)."""
    name = "seamless-m4t-large-v2"
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(JAX_REGISTRY[name])
    assert (dataclasses.asdict(get_config(name).reduced())
            == dataclasses.asdict(JAX_REGISTRY[name].reduced()))
    assert get_config(name).param_count() == JAX_REGISTRY[name].param_count()
    shapes = jax.eval_shape(lambda k: JM.init_params(JAX_REGISTRY[name], k), jax.random.key(0))
    meta = TM.init_params(get_config(name), torch.Generator(), device="meta")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, meta)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, shapes))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in jax.tree.leaves(meta)] == [
        (tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(shapes)]
    assert sum(t.numel() for t in jax.tree.leaves(meta)) == 2_034_784_256


# -------------------------------------------------------------------- layers
def test_rmsnorm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    got = tl.rmsnorm_apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6)
    want = jl.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)

    positions = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        rope = tl.rope_tables(torch.from_numpy(positions), 32, theta)
        got = tl.apply_rope(torch.from_numpy(x), rope)
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)

    p = jl.mlp_init(jax.random.key(1), 32, 48)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = tl.mlp_apply(_to_torch(p), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.mlp_apply(p, jnp.asarray(h))), **F32_TOL)


@pytest.mark.parametrize("variant", ["plain", "qkv_bias", "qk_norm", "window"])
def test_attn_apply_and_decode_match_reference(variant):
    """Full-sequence attention and token-by-token decode against a cache
    (a ring buffer for the window) agree with the reference layer by layer."""
    acfg = jl.AttnConfig(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                         qkv_bias=variant == "qkv_bias", qk_norm=variant == "qk_norm",
                         sliding_window=6 if variant == "window" else None)
    tcfg = tl.AttnConfig(*acfg)
    p = jl.attn_init(jax.random.key(2), acfg)
    if variant == "qkv_bias":  # nonzero biases, so they matter
        for name in ("wq", "wk", "wv"):
            p[name]["b"] = jax.random.normal(jax.random.key(3), p[name]["b"].shape)
    tp = _to_torch(p)
    x = np.random.default_rng(4).standard_normal((2, 11, 64)).astype(np.float32)
    rope = tl.rope_tables(torch.arange(11), 16, tcfg.rope_theta)
    got = tl.attn_apply(tp, tcfg, torch.from_numpy(x), rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.attn_apply(p, acfg, jnp.asarray(x))),
                               **F32_TOL)

    S = 6 if variant == "window" else 16
    jstep = jax.jit(lambda p, x, k, v, pos: jl.attn_decode_apply(p, acfg, x, k, v, pos))
    jk = jv = jnp.zeros((2, S, 2, 16), jnp.float32)
    tk, tv = torch.zeros((2, S, 2, 16)), torch.zeros((2, S, 2, 16))
    for pos in range(11):
        xt = x[:, pos:pos + 1]
        want, jk, jv = jstep(p, jnp.asarray(xt), jk, jv, pos)
        tables = tl.decode_tables(tcfg, pos, S, "cpu")
        got, tk2, tv2 = tl.attn_decode_apply(tp, tcfg, torch.from_numpy(xt), tk, tv, pos, tables)
        assert tk2 is tk and tv2 is tv  # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32_TOL)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(-1, 33, (2, 7))
    for z in (0.0, 1e-3):
        got = tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z)
        want = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# --------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_forward_and_decode_match_reference(name, dtype):
    """Reduced dense configs: llama (MHA once reduced), qwen2 (qkv bias),
    qwen3 (qk norm), granite.  Full-sequence logits, the loss, and every
    decode step's logits and cache against `repro.models.model`."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, jparams, tcfg, tparams = _models(name, dtype)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 12))
    labels = rng.integers(-1, tcfg.vocab_size, (2, 12))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}

    jlogits, _ = JM.forward(jparams, jcfg, jbatch)
    tlogits, aux = TM.forward(tparams, tcfg, tbatch)
    assert tlogits.shape == (2, 12, tcfg.vocab_size) and tlogits.dtype == getattr(torch, dtype)
    assert aux.item() == 0.0
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **tol)
    np.testing.assert_allclose(TM.loss_fn(tparams, tcfg, tbatch).item(),
                               float(JM.loss_fn(jparams, jcfg, jbatch)), **tol)

    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = TM.init_decode_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(12):
        jl_t, jcache = jstep(jparams, jbatch["tokens"][:, t], jcache, t)
        tl_t, tcache = TM.decode_step(tparams, tcfg, tbatch["tokens"][:, t], tcache, t)
        np.testing.assert_allclose(_np(tl_t), _np(jl_t), **tol, err_msg=f"step {t}")
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **tol)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), **tol)


def test_sliding_window_model_matches_reference():
    """Long-context mode: windowed full-sequence attention and a ring-buffer
    cache that wraps (8 slots, 14 tokens)."""
    jcfg, tcfg = _configs("llama3.2-3b", "float32")
    jcfg, tcfg = jcfg.with_sliding_window(8), tcfg.with_sliding_window(8)
    jparams = JM.init_params(jcfg, jax.random.key(7))
    tparams = convert.dense_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tokens = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 14))
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tlogits, _ = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = TM.init_decode_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    assert tcache["k"].shape[2] == 8
    for t in range(14):
        jl_t, jcache = jstep(jparams, jnp.asarray(tokens[:, t], jnp.int32), jcache, t)
        tl_t, tcache = TM.decode_step(tparams, tcfg, torch.from_numpy(tokens[:, t]), tcache, t)
        np.testing.assert_allclose(tl_t.numpy(), np.asarray(jl_t), **F32_TOL, err_msg=f"step {t}")


def test_convert_checks_the_tree():
    jcfg, jparams, tcfg, tparams = _models("qwen2-1.5b", "bfloat16")
    assert tparams["layers"]["attn"]["wq"]["b"].shape == (2, tcfg.num_heads * tcfg.head_dim)
    assert tparams["embed"]["emb"].dtype == torch.bfloat16
    tree = jax.tree.map(np.asarray, jparams)
    np.testing.assert_array_equal(_np(tparams["head"]["w"]), _np(jparams["head"]["w"]))
    del tree["layers"]["attn"]["wq"]["b"]
    with pytest.raises(ValueError, match="expected keys"):
        convert.dense_params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["head"]["w"] = tree["head"]["w"].T
    with pytest.raises(ValueError, match="expected shape"):
        convert.dense_params_from_numpy(tree, tcfg, device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, tcfg = _configs("granite-3-2b", "float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_decode_cache(tcfg, 1, 8)
