"""The port's attention kernels (K4, K5) against the reference's, on the CPU.

On the CPU `repro_torch.kernels.flash_attention.flash_attention` and
`...decode_attention.decode_attention` run their plain PyTorch versions;
these tests hold them against the Pallas kernels run as the reference's own
tests run them (`interpret=True`, called directly) and against the
reference's oracles (`repro.kernels.ref`), on the same numpy inputs.
Tolerances are the reference's: flash attention f32 2e-5 / bf16 2e-2
(tests/test_kernels_attention.py:_tol), decode attention f32 2e-5 / bf16
3e-2 (tests/test_kernels_decode.py).  bf16 inputs are the same float32
numbers rounded to bfloat16 by each framework (round to nearest even in
both, so the two packages see identical values).  The CUDA kernels are held
against these plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

K4_TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
K5_TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    flash_attention.launches = decode_attention.launches = 0
    yield
    assert flash_attention.launches == decode_attention.launches == 0  # CPU: plain versions only


FLASH_CASES = [
    # (B, Sq, Skv, H, KVH, Dh, causal, window, q_offset)
    (1, 64, 64, 4, 4, 32, True, None, 0),  # MHA, causal
    (2, 130, 130, 8, 2, 16, True, None, 0),  # GQA, ragged length
    (2, 96, 48, 4, 2, 16, False, None, 0),  # non-causal, Sq != Skv (cross-attention lengths)
    (2, 128, 128, 4, 2, 16, True, 16, 0),  # sliding window
    (1, 100, 100, 6, 3, 8, True, 40, 0),  # window, ragged, odd head dim
    (2, 40, 104, 4, 2, 16, True, None, 64),  # causal chunk at an offset, Sq != Skv
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_plain_matches_pallas(case, dtype):
    B, Sq, Skv, H, KVH, Dh, causal, window, q_offset = case
    q, k, v = _inputs([(B, Sq, H, Dh), (B, Skv, KVH, Dh), (B, Skv, KVH, Dh)], seed=sum(case[:6]))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    got = flash_attention(qt, kt, vt, **kw)
    assert got.shape == (B, Sq, H, Dh) and got.dtype == qt.dtype
    pallas = pallas_flash(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), **K4_TOL[dtype])
    oracle = ref.naive_attention(qj, kj, vj, **kw)
    np.testing.assert_allclose(_np(got), _np(oracle), **K4_TOL[dtype])


def test_flash_attention_rows_without_keys_are_zero():
    """A window shorter than the gap to every key leaves rows with nothing to
    attend; both the Pallas kernel and the port give 0 there."""
    q, k, v = _inputs([(1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)], seed=3)
    kw = dict(causal=True, sliding_window=4, q_offset=20)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    pallas = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), block_q=8, block_k=8,
                          interpret=True, **kw)
    assert not got.abs().any()
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **K4_TOL["float32"])


DECODE_CASES = [
    # (B, S, H, KVH, Dh)
    (2, 100, 4, 2, 16),
    (1, 257, 8, 4, 32),
    (3, 64, 6, 3, 8),
]


def _masks(S):
    """Prefixes (a full cache at three positions) and a ring buffer's
    scattered validity (slots of a window of S // 2 positions ending at
    1.5 S, as layers.attn_decode_apply computes them)."""
    idx = np.arange(S)
    pos, window = S + S // 2, S // 2
    abs_pos = idx + S * ((pos - idx) // S)
    ring = (abs_pos >= 0) & (abs_pos <= pos) & (pos - abs_pos < window)
    return {"prefix0": idx <= 0, "prefix_half": idx <= S // 2, "prefix_full": idx <= S - 1,
            "ring": ring, "scattered": idx % 3 != 0}


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_decode_attention_plain_matches_pallas(case, q_dtype, cache_dtype):
    """q and the cache may differ in dtype (bf16 compute against the serving
    engine's default float32 cache); the Pallas kernel casts both to f32."""
    B, S, H, KVH, Dh = case
    q, k, v = _inputs([(B, 1, H, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh)], seed=sum(case))
    qj, qt = _pair(q, q_dtype)
    (kj, kt), (vj, vt) = _pair(k, cache_dtype), _pair(v, cache_dtype)
    tol = K5_TOL["bfloat16" if "bfloat16" in (q_dtype, cache_dtype) else "float32"]
    for name, valid in _masks(S).items():
        got = decode_attention(qt, kt, vt, torch.from_numpy(valid))
        assert got.shape == (B, 1, H, Dh) and got.dtype == qt.dtype, name
        pallas = pallas_decode(qj, kj, vj, jnp.asarray(valid), block_s=32, interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **tol, err_msg=name)
        oracle = ref.naive_decode_attention(qj, kj, vj, jnp.asarray(valid))
        np.testing.assert_allclose(_np(got), _np(oracle), **tol, err_msg=name)


def test_ops_names_the_kernels(monkeypatch):
    """`ops` is what the model code calls: the wrappers themselves, so their
    launch counts see every call the model makes.  Full-sequence attention
    calls K4's wrapper when no input needs a gradient, and its autograd
    Function (K4 forward, K4b backward) when one does."""
    assert ops.decode_attention is decode_attention
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    q, k, v = (torch.randn(1, 5, 2, 16) for _ in range(3))
    assert ops.attention(q, k, v, sliding_window=3).grad_fn is None
    assert calls == [dict(causal=True, sliding_window=3, q_offset=0)]
    q.requires_grad_()
    assert ops.attention(q, k, v).grad_fn is not None and len(calls) == 1
    with torch.no_grad():
        ops.attention(q, k, v)
    assert len(calls) == 2
