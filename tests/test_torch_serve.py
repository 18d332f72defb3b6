"""The port's serving engine and inference steps (`repro_torch.launch`)
against `repro.launch`, on the CPU.

The model is tests/test_serve.py's fixture: reduced qwen2 (qkv bias) at
width 64, float32, weights drawn by the reference and converted.  In float32
greedy decoding picks the same tokens in both packages (their logits agree
to ~1e-6); the prefill step's logits are held to rtol = atol = 1e-4 as in
tests/test_torch_models.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.launch.serve import BatchServer as JaxServer  # noqa: E402
from repro.launch.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

SMALL = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
             d_ff=128, param_dtype="float32", compute_dtype="float32")
PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [11, 3, 12, 13, 14]]  # ragged, 5 requests


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JAX_REGISTRY["qwen2-1.5b"].reduced(), **SMALL)
    tcfg = dataclasses.replace(REGISTRY["qwen2-1.5b"].reduced(), **SMALL)
    jparams = JM.init_params(jcfg, jax.random.key(0))
    tparams = convert.dense_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    flash_attention.launches = decode_attention.launches = 0
    yield
    assert flash_attention.launches == decode_attention.launches == 0  # CPU: plain versions only


def _server(setup, **kw):
    _, _, tcfg, tparams = setup
    return BatchServer(tcfg, tparams, ServeConfig(cache_len=64, **kw), device="cpu")


def test_greedy_tokens_equal_reference(setup):
    """Ragged prompts, max_batch (2) below the number of requests (5), the
    reference's default float32 cache."""
    jcfg, jparams, _, _ = setup
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=2, cache_len=64)).generate(
        PROMPTS, max_new_tokens=7)
    got = _server(setup, max_batch=2).generate(PROMPTS, max_new_tokens=7)
    assert got == want
    assert [len(o) for o in got] == [7] * 5


def test_batched_generation_shapes(setup):
    outs = _server(setup, max_batch=3).generate(PROMPTS[:4], max_new_tokens=6)
    assert len(outs) == 4
    assert all(len(o) == 6 for o in outs)
    assert all(0 <= t < SMALL["vocab_size"] for o in outs for t in o)


def test_greedy_batch_matches_single(setup):
    """Batch-of-one must agree with batch-of-many for equal-length prompts
    (no padding effects)."""
    srv = _server(setup, max_batch=2)
    p1, p2 = [3, 1, 4, 1], [2, 7, 1, 8]
    both = srv.generate([p1, p2], max_new_tokens=5)
    assert both[0] == srv.generate([p1], max_new_tokens=5)[0]
    assert both[1] == srv.generate([p2], max_new_tokens=5)[0]


def test_temperature_sampling_varies(setup):
    srv = _server(setup, max_batch=1, temperature=5.0)
    a = srv.generate([[1, 2, 3]], max_new_tokens=12, generator=torch.Generator().manual_seed(1))[0]
    b = srv.generate([[1, 2, 3]], max_new_tokens=12, generator=torch.Generator().manual_seed(2))[0]
    assert a != b  # hot sampling with different generators should diverge
    again = srv.generate([[1, 2, 3]], max_new_tokens=12, generator=torch.Generator().manual_seed(1))
    assert again[0] == a  # and one generator seed replays
    assert srv.generate([[1, 2, 3]], max_new_tokens=12) == srv.generate([[1, 2, 3]], max_new_tokens=12)


def test_server_refuses_what_is_not_ported(setup):
    """int8 serving, ported since, quantizes at construction (the MLP
    weights: the other matrices of this width-64 model are below the
    1 << 14 elements quantization starts at) and serves the reference's
    quantized server's greedy tokens; what stays refused: a cache too short,
    the card by default when there is none."""
    jcfg, jparams, tcfg, tparams = setup
    srv = _server(setup, max_batch=2, quantize=True)
    assert set(srv.params["layers"]["mlp"]["up"]["w"]) == {"q", "s"}
    assert isinstance(srv.params["layers"]["attn"]["wq"]["w"], torch.Tensor)
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=2, cache_len=64, quantize=True)
                     ).generate(PROMPTS, max_new_tokens=7)
    assert srv.generate(PROMPTS, max_new_tokens=7) == want
    with pytest.raises(ValueError, match="cache too short"):
        _server(setup).generate([[1] * 60], max_new_tokens=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchServer(tcfg, tparams)


def test_prefill_and_serve_steps_match_reference(setup):
    """The single-device steps: last-position logits of a full forward, and
    one decode step, against the reference's forward and decode_step."""
    jcfg, jparams, tcfg, tparams = setup
    tokens = np.random.default_rng(0).integers(0, SMALL["vocab_size"], (3, 9))
    got = make_prefill_step(tcfg, device="cpu")(tparams, {"tokens": tokens})
    want = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})[0][:, -1]
    assert got.shape == (3, SMALL["vocab_size"])
    # its own storage: a view of the last position would keep every position's logits alive
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    step = make_serve_step(tcfg, device="cpu")
    cache = TM.init_decode_cache(tcfg, 3, 16, dtype=torch.float32, device="cpu")
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = JM.init_decode_cache(jcfg, 3, 16, dtype=jnp.float32)
    for t in range(9):
        logits, cache = step(tparams, cache, tokens[:, t], t)
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t], jnp.int32), jcache, t)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), got.numpy(), rtol=1e-4, atol=1e-4)
