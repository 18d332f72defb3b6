"""The port's int8 weight-only serving (`repro_torch.quant`, the int8
branches of `models.layers`, `BatchServer(quantize=True)`) against
`repro.quant`, on the CPU.

The reference's weights cross into the port as numpy; the hybrid and ssm
models have the leaves that init leaves at zeros or ones randomised, as in
tests/test_torch_hybrid.py and tests/test_torch_rwkv.py.  Quantizing is
exact arithmetic on the same values, so ``q`` and ``s`` equal the
reference's bit for bit, in float32 and in bfloat16 (the scale is
``max(amax, 1e-12) / 127`` by true division, as the reference's eager
`quantize_params`; the reciprocal product of the quant8 channel differs in
a few percent of the channels).  Dequantised weights are then equal too,
so the int8 models differ from the reference's only as the float32 models
do, by summation order: the int8 decode logits are held to rtol 1e-5 and
atol 1e-5 of the logits' largest magnitude, and greedy tokens to equality.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import np_tree  # noqa: E402
from repro import quant as jquant  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.launch.serve import BatchServer as JaxServer  # noqa: E402
from repro.launch.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.utils.tree import tree_bytes as jtree_bytes  # noqa: E402
from repro.utils.tree import tree_size as jtree_size  # noqa: E402
from repro_torch import convert, quant  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.launch import BatchServer, ServeConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.utils.tree import tree_bytes, tree_size  # noqa: E402
from test_torch_hybrid import _models as hybrid_models  # noqa: E402
from test_torch_rwkv import SERVE_VARIANT as RWKV_SERVE_VARIANT  # noqa: E402
from test_torch_rwkv import _models as rwkv_models  # noqa: E402

DECODE_RTOL = 1e-5
PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [11, 3, 12, 13, 14]]  # ragged, 5 requests
CONVERT = {"dense": convert.dense_params_from_numpy, "hybrid": convert.hybrid_params_from_numpy,
           "ssm": convert.ssm_params_from_numpy}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name, dtype, **extra):
    """(jcfg, jparams, tcfg, tparams): the reduced ``name`` in ``dtype``."""
    if name == "zamba2-2.7b":
        return hybrid_models(dtype)
    if name == "rwkv6-1.6b":
        return rwkv_models(dtype, **extra)
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **extra)
    jcfg = dataclasses.replace(JAX_REGISTRY[name].reduced(), **kw)
    tcfg = dataclasses.replace(REGISTRY[name].reduced(), **kw)
    jparams = JM.init_params(jcfg, jax.random.key(0))
    return jcfg, jparams, tcfg, CONVERT[tcfg.family](np_tree(jparams), tcfg, device="cpu")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(got, want, what=""):
    """A port tree equal to a jax tree bit for bit, dtypes included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}/{k}")
        return
    gb, wb = _bits(got), _bits(want)
    assert gb.dtype == wb.dtype and gb.shape == wb.shape, (what, gb.dtype, wb.dtype)
    np.testing.assert_array_equal(gb, wb, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "llama3.2-3b", "zamba2-2.7b", "rwkv6-1.6b"])
def test_quantized_tree_equals_reference(name, dtype):
    """Every ``q`` and ``s`` (and every leaf left as it is) bit for bit: the
    stacked (L, ...) and (G, per_group, ...) weights keep their own
    per-column scales, the embedding its per-row ones."""
    _, jparams, _, tparams = _models(name, dtype)
    jq, tq = jquant.quantize_params(jparams), quant.quantize_params(tparams)
    _assert_same(tq, jq, name)
    assert set(tq["embed"]["emb"]) == {"q", "s"}
    assert tq["embed"]["emb"]["s"].shape == (tparams["embed"]["emb"].shape[0], 1)


def test_quantize_leaf_edge_cases():
    """tests/test_channel.py's quantizer hardening, each case bit for bit
    with the reference's `quantize_leaf` where it returns."""
    for a in (np.zeros((0, 8), np.float32), np.zeros((4, 0), np.float32),
              np.asarray([[3.0], [-1.5], [0.25]], np.float32), np.zeros((4, 300), np.float32),
              np.random.default_rng(0).standard_normal((5, 300)).astype(np.float32)):
        want = jquant.quantize_leaf(jnp.asarray(a))
        got = quant.quantize_leaf(torch.from_numpy(a))
        _assert_same(got, want, str(a.shape))
        back = quant.dequantize_leaf(got)
        assert back.shape == a.shape and bool(torch.isfinite(back).all())
        _assert_same(back, jquant.dequantize_leaf(want))
    np.testing.assert_allclose(quant.dequantize(quant.quantize_leaf(
        torch.tensor([[3.0], [-1.5], [0.25]]))).numpy()[:, 0], [3.0, -1.5, 0.25], rtol=1e-2)
    assert not quant.dequantize_leaf(quant.quantize_leaf(torch.zeros(4, 300))).any()
    with pytest.raises(TypeError, match="array leaf"):
        quant.quantize_leaf([1.0, 2.0])
    with pytest.raises(ValueError, match="ndim"):
        quant.quantize_leaf(torch.tensor(1.0))
    with pytest.raises(TypeError, match="float"):
        quant.quantize_leaf(torch.arange(5))
    with pytest.raises(TypeError, match="dict"):
        quant.dequantize_leaf(torch.zeros(3))
    with pytest.raises(TypeError, match="dict"):
        quant.dequantize_leaf({"q": torch.zeros(3, dtype=torch.int8)})
    with pytest.raises(TypeError, match="leaf at layers/bad is NoneType"):
        quant.quantize_params({"layers": {"bad": None}})


def test_dequantize_error_and_bytes():
    """`dequantize_params` keeps the tree and equals the reference's bit for
    bit; `quantization_error` below 1.2/127 and equal to the reference's;
    `tree_bytes` of the int8 tree below 0.35 of float32's and equal to the
    reference's count (int8 values plus float32 scales)."""
    _, jparams, _, tparams = _models("qwen2-1.5b", "float32")
    tq = quant.quantize_params(tparams)
    jq = jquant.quantize_params(jparams)
    _assert_same(quant.dequantize_params(tq), jquant.dequantize_params(jq))
    err = quant.quantization_error(tparams, tq)
    assert err < 1.2 / 127.0
    np.testing.assert_allclose(err, jquant.quantization_error(jparams, jq), rtol=1e-6)
    _, jparams, _, tparams = _models("llama3.2-3b", "float32")
    tq, jq = quant.quantize_params(tparams), jquant.quantize_params(jparams)
    assert tree_bytes(tq) == jtree_bytes(jq) < 0.35 * tree_bytes(tparams)
    assert tree_bytes(tparams) == jtree_bytes(jparams)
    assert tree_size(tq) == jtree_size(jq)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-2.7b", "rwkv6-1.6b"])
def test_int8_decode_step_matches_reference(name):
    """Five teacher-forced decode steps of the int8 model in float32, the
    quantized trees made by each package from the same weights: the logits
    against the reference's int8 `decode_step`, and within the
    reference's own bound (0.12, tests/test_quant.py) of the float32 model."""
    jcfg, jparams, tcfg, tparams = _models(name, "float32")
    jq, tq = jquant.quantize_params(jparams), quant.quantize_params(tparams)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 5))
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 2, 16, dtype=jnp.float32)
    cache = TM.init_decode_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    cache32 = TM.init_decode_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(tokens.shape[1]):
        jlogits, jcache = jstep(jq, jnp.asarray(tokens[:, t], jnp.int32), jcache, t)
        logits, cache = TM.decode_step(tq, tcfg, torch.from_numpy(tokens[:, t]), cache, t)
        want = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), want, rtol=DECODE_RTOL,
                                   atol=DECODE_RTOL * np.abs(want).max(), err_msg=f"step {t}")
        full, cache32 = TM.decode_step(tparams, tcfg, torch.from_numpy(tokens[:, t]), cache32, t)
        rel = (full - logits).abs().max() / full.abs().max()
        assert rel < 0.12, (t, float(rel))


@pytest.mark.parametrize("name", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_int8_server_greedy_tokens_equal_reference(name):
    """`BatchServer(quantize=True)` against `repro.launch.serve`'s, float32,
    ragged prompts over batches of 2 (dense: tests/test_torch_serve.py)."""
    extra = RWKV_SERVE_VARIANT if name == "rwkv6-1.6b" else {}
    jcfg, jparams, tcfg, tparams = _models(name, "float32", **extra)
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=2, cache_len=32, quantize=True)
                     ).generate(PROMPTS, max_new_tokens=5)
    srv = BatchServer(tcfg, tparams, ServeConfig(max_batch=2, cache_len=32, quantize=True),
                      device="cpu")
    assert tree_bytes(srv.params) < tree_bytes(tparams)  # some matrices are int8
    assert srv.generate(PROMPTS, max_new_tokens=5) == want
