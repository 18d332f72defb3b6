"""The port's attention gradient (`ops.attention` under autograd, through the
`FlashAttention` Function) against `jax.grad` of `repro.kernels.ops.attention`,
on the CPU.

On the CPU the Function runs K4's plain forward (which also returns the
log-sum-exp) and K4b's plain backward, the wiring the card runs with the
kernels; the reference runs its chunked `custom_vjp` (`_ca_fwd` / `_ca_bwd`,
chunk 32 so the scan crosses chunks).  Inputs come from a numpy seed.
Tolerances are the reference's own (tests/test_kernels_attention.py:59-78):
the value rtol 1e-5, gradients atol 5e-5 and rtol 5e-4; the log-sum-exp
within 1e-6 of `_chunked_attention_fwd_impl`'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward_route,
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
    forward_route,
)

GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
CASES = {
    # name: (B, Sq, Skv, H, KVH, Dh, causal, window, q_offset)
    "causal": (2, 100, 100, 6, 2, 16, True, None, 0),
    "window23": (2, 100, 100, 6, 2, 16, True, 23, 0),
    "noncausal": (2, 100, 100, 6, 2, 16, False, None, 0),
    "offset": (2, 40, 100, 6, 2, 16, True, None, 60),
    "empty_rows": (2, 30, 30, 6, 2, 16, True, 8, 20),  # rows at positions >= 37 see no key
}


def _inputs(case, seed=0):
    B, Sq, Skv, H, KVH, Dh, causal, window, q_offset = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, Dh)).astype(np.float32)
    return (q, k, v), dict(causal=causal, sliding_window=window, q_offset=q_offset)


@pytest.mark.parametrize("name", list(CASES))
def test_attention_gradient_matches_reference(name):
    (q, k, v), kw = _inputs(CASES[name])

    def f_ref(q, k, v):
        return jnp.sum(jnp.tanh(kops.attention(q, k, v, chunk=32, **kw)))

    want_val = float(f_ref(*map(jnp.asarray, (q, k, v))))
    want = jax.grad(f_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    val = torch.tanh(ops.attention(*leaves, **kw)).sum()
    got = torch.autograd.grad(val, leaves)
    assert flash_attention.launches == 0 and flash_attention_bwd.launches == 0
    np.testing.assert_allclose(val.item(), want_val, rtol=1e-5)
    for name_, a, b in zip("qkv", got, want):
        assert bool(torch.isfinite(a).all()), name_
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=f"d{name_}")
    if name == "empty_rows":  # rows with no key: zero gradient, no NaN
        assert bool((got[0][:, 17:] == 0).all())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_lse_matches_reference(name):
    case = CASES[name]
    (q, k, v), kw = _inputs(case, seed=1)
    B, Sq, Skv, H, KVH, Dh = case[:6]
    want_out, want_lse = kops._chunked_attention_fwd_impl(*map(jnp.asarray, (q, k, v)), chunk=32,
                                                          **kw)
    out, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), with_lse=True, **kw)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(B, H, Sq),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)


def test_backward_routes():
    """K4b's route: bf16 with a group of at most 8 query heads a kv head
    takes the wgmma + TMA kernel at every built head dim (Zamba2's 80 too),
    a larger group the mma.sync kernels, float32 the FMA kernels."""
    bf16 = torch.bfloat16
    for dh in (64, 80, 128):
        assert backward_route(bf16, dh, 1) == backward_route(bf16, dh, 8) == "wgmma_tma"
        assert backward_route(bf16, dh, 16) == "mma_sync"
        assert backward_route(torch.float32, dh, 1) == "fma_f32"


@pytest.mark.parametrize("dh", [64, 80, 128])
def test_forward_routes(dh):
    """K4's route depends on dtype alone: bf16 takes the wgmma + TMA kernel
    at every built head dim (Zamba2's 80 in 16-column boxes with the 32-byte
    swizzle), float32 the FMA kernel."""
    assert forward_route(torch.bfloat16, dh) == "wgmma_tma"
    assert forward_route(torch.float32, dh) == "fma_f32"
