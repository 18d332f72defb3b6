"""The gradient of the port's RWKV-6 WKV scan (K7, K7b) against the reference's, on the CPU.

On the CPU `kernels.ops.rwkv6_scan` under autograd runs `RWKV6Scan` with
the plain forward `rwkv6_scan_plain` and the plain backward
`rwkv6_scan_bwd_plain` (the reverse recurrence K7b runs, written out in
PyTorch, not autograd).  These tests hold its gradients, for every input
(r, k, v, w, u and state0) and a cotangent on both y and the final state,
against ``jax.vjp`` of the reference's oracle `ref.rwkv6_scan` (its
`lax.scan`, what the reference's models differentiate off the TPU), on the
same numpy inputs:

* float64 at rtol 1e-9 (atol 1e-9 of each gradient's largest magnitude,
  for elements that sum to near zero): the reference's code with its
  float32 casts read as float64 (`reference_in_float64`,
  tests/_torch_replay.py; nothing in `repro` is edited);
* float32 at the reference's gradient tolerance, rtol = atol = 1e-3
  (tests/test_kernels_scans.py:62-74).

The reference's shapes (tests/test_kernels_scans.py:10), and strong (w in
[0.01, 0.1]) and weak (w in [0.99, 0.999]) decay.  A gradient through two
halves of a sequence with the state carried equals the gradient through
the whole, and `gradcheck` holds `RWKV6Scan` against finite differences.
dw is read from S_{t-1} itself: with w down to 1e-30 (exp(-exp(w_raw)) at
w_raw = 4.2) it stays finite and equal to the reference's.  K7b itself is
held against the plain backward on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import reference_in_float64  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    RWKV6Scan,
    rwkv6_scan,
    rwkv6_scan_bwd,
    rwkv6_scan_bwd_plain,
)

F64_RTOL = 1e-9  # atol: F64_RTOL of the gradient's largest magnitude
F32_TOL = dict(rtol=1e-3, atol=1e-3)
NAMES = ("r", "k", "v", "w", "u", "state0")
SHAPES = [(1, 33, 2, 8), (2, 100, 3, 16), (1, 64, 4, 32)]  # (B, T, H, K)
DECAYS = {"sigmoid": None, "strong": (0.01, 0.1), "weak": (0.99, 0.999)}


def _inputs(shape, decay="sigmoid", seed=0):
    """float64 numpy inputs rounded to float32 values: w = sigmoid(normal)
    or uniform in a decay band, state0 and the two cotangents."""
    B, T, H, K = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)) for _ in range(3))
    band = DECAYS[decay]
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, K)))) if band is None
         else rng.uniform(*band, (B, T, H, K)))
    u = rng.standard_normal((H, K))
    s0 = rng.standard_normal((B, H, K, K))
    dy, dS = rng.standard_normal((B, T, H, K)), rng.standard_normal((B, H, K, K))
    return [a.astype(np.float32).astype(np.float64) for a in (r, k, v, w, u, s0, dy, dS)]


def _reference_grads(arrays, dtype):
    *ins, dy, dS = (jnp.asarray(a, dtype) for a in arrays)
    out, vjp = jax.vjp(lambda *a: ref.rwkv6_scan(*a), *ins)
    return out, vjp((dy.astype(out[0].dtype), dS.astype(out[1].dtype)))


def _port_grads(arrays, dtype):
    *ins, dy, dS = (torch.tensor(a, dtype=dtype) for a in arrays)
    ins = [t.requires_grad_() for t in ins]
    y, S = ops.rwkv6_scan(*ins)
    return (y, S), torch.autograd.grad([y, S], ins, [dy, dS.to(S.dtype)])


def _assert_close(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        assert np.isfinite(g.numpy()).all(), name
        w = np.asarray(w)
        t = tol or dict(rtol=F64_RTOL, atol=F64_RTOL * np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, **t, err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", [(s, "sigmoid") for s in SHAPES] +
                         [(SHAPES[1], "strong"), (SHAPES[1], "weak")],
                         ids=lambda c: "x".join(map(str, c[0])) + f"_{c[1]}")
def test_gradient_matches_reference(case, dtype):
    shape, decay = case
    arrays = _inputs(shape, decay)
    if dtype == "float64":
        with reference_in_float64(ref):
            (want_y, want_S), want = _reference_grads(arrays, jnp.float64)
        tol = None
    else:
        (want_y, want_S), want = _reference_grads(arrays, jnp.float32)
        tol = F32_TOL
    (y, S), got = _port_grads(arrays, getattr(torch, dtype))
    assert y.dtype == S.dtype == getattr(torch, dtype)
    assert all(g.dtype == getattr(torch, dtype) for g in got)
    _assert_close([y.detach(), S.detach(), *got], [want_y, want_S, *want], tol,
                  ("y", "state") + NAMES)


def test_vanishing_decay_keeps_dw():
    """w as the model forms it, exp(-exp(w_raw)), with w_raw up to 4.2: some
    w underflow to ~1e-30 and below.  dw comes from S_{t-1}, not S_t / w_t, so
    it stays finite and equal to the reference's (float64)."""
    arrays = _inputs((1, 40, 2, 8), seed=4)
    w_raw = np.random.default_rng(5).uniform(-6.0, 4.2, arrays[3].shape)
    arrays[3] = np.exp(-np.exp(w_raw))
    assert arrays[3].min() < 1e-25
    with reference_in_float64(ref):
        _, want = _reference_grads(arrays, jnp.float64)
    _, got = _port_grads(arrays, torch.float64)
    _assert_close(got, want, None, NAMES)


def test_split_sequence_gradient_equals_whole():
    """Two halves with the state carried: the same gradients as one call."""
    *arrays, dy, dS = (torch.tensor(a) for a in _inputs((2, 100, 3, 16), seed=2))

    def grads(split):
        ins = [t.clone().requires_grad_() for t in arrays]
        r, k, v, w, u, s0 = ins
        if split is None:
            y, S = ops.rwkv6_scan(*ins)
        else:
            a, b = slice(None, split), slice(split, None)
            y1, S1 = ops.rwkv6_scan(r[:, a], k[:, a], v[:, a], w[:, a], u, s0)
            y2, S = ops.rwkv6_scan(r[:, b], k[:, b], v[:, b], w[:, b], u, S1)
            y = torch.cat([y1, y2], dim=1)
        return torch.autograd.grad([y, S], ins, [dy, dS])

    for name, a, b in zip(NAMES, grads(37), grads(None)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


def test_gradcheck_and_the_cpu_path():
    """Finite differences in float64; `rwkv6_scan_bwd` on CPU tensors is the
    plain backward; without state0 there is no dstate0; an ``out_state``
    cannot carry a gradient; the scan called directly on CPU tensors stays
    differentiable (the plain forward)."""
    *ins, dy, dS = (torch.tensor(a) for a in _inputs((1, 6, 2, 4), seed=3))
    leaves = [t.clone().requires_grad_() for t in ins]
    assert torch.autograd.gradcheck(lambda *a: RWKV6Scan.apply(*a), leaves)
    r, k, v, w, u, s0 = (t.float() for t in ins)
    got = rwkv6_scan_bwd(r, k, v, w, u, None, dy.float())
    want = rwkv6_scan_bwd_plain(r, k, v, w, u, None, dy.float())
    assert got[-1] is None and want[-1] is None
    for a, b in zip(got[:-1], want[:-1]):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = ops.rwkv6_scan(*leaves)
    g = torch.autograd.grad(y, leaves, dy.float())
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="out_state"):
        ops.rwkv6_scan(*leaves, out_state=torch.zeros_like(s0))
    y, _ = rwkv6_scan(*leaves)
    assert y.requires_grad
