"""The gradient of the port's Mamba-2 scan (K6, K6b) against the reference's, on the CPU.

On the CPU `kernels.ops.ssm_scan` under autograd runs `SSMScan` with the
plain forward `ssm_scan_plain` and the plain backward `ssm_scan_bwd_plain`
(the chunked formulas K6b runs, written out in PyTorch, not autograd).
These tests hold its gradients, for every input (x, dt, A, B, C, D and
state0) and a cotangent on both y and the final state, against
``jax.vjp`` of the reference's `ssm_scan_chunked` (what the reference's
models differentiate off the TPU), on the same numpy inputs:

* float64 at rtol 1e-9: the reference's code with its float32 casts read
  as float64 (`reference_in_float64`, tests/_torch_replay.py: the module's
  ``jnp`` seen through a proxy whose ``float32`` is ``float64``; nothing in
  `repro` is edited), with an atol of 1e-9 of each gradient's largest magnitude: autodiff of
  the chunked form cancels E's diagonal in rounding where the plain
  backward sums the rectangle it leaves (csrc/ssm_scan_bwd.cu), and under
  strong decay dA is small enough (~1e-2) that this float64 noise of the
  reference's, 2.4e-12, reads 1.9e-9 relative;
* float32 at the reference's gradient tolerance, rtol = atol = 1e-3
  (tests/test_kernels_scans.py:62-74).

The reference's shapes (tests/test_kernels_scans.py:10-11), strong decay
(A = -16, dt in [0.5, 4]: every step decays the state by e^-8 or more; the
masked exponents must not reach exp) and weak decay (A near 0).  The plain
backward at K6b's 64-step chunk equals it at the reference's 128 (rtol
1e-10 in float64), and a gradient through two halves of a sequence with the
state carried equals the gradient through the whole.  `gradcheck` holds
`SSMScan` against finite differences.  K6b itself is held against the plain
backward on the card (tests/test_torch_gpu.py, chip_smoke.py).

`ssm_scan_bwd_split_plain` models the arithmetic of K6b's bf16 tensor-core
route (64-step chunks whose increments are combined over the chunks, every
float32 operand of a product split into bf16 high and low parts): each of
its gradients lies within SPLIT_REL_L2 in relative L2 of the float64
reference's at the reference's chunk of 64 steps (the split leaves ~3e-6,
2.5e-5 on dA under strong decay); without the low parts (~1e-3) it does not.
`bwd_route` and `bwd_group` are held to the rules the C entry points take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import reference_in_float64  # noqa: E402
from repro.kernels import _ssm_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    K6_CHUNK,
    SSMScan,
    ssm_scan,
    bwd_group,
    bwd_route,
    scan_route,
    ssm_scan_bwd,
    ssm_scan_bwd_plain,
    ssm_scan_bwd_split_plain,
)

F64_RTOL = 1e-9  # atol: F64_RTOL of the gradient's largest magnitude
F32_TOL = dict(rtol=1e-3, atol=1e-3)
SPLIT_REL_L2 = 1e-4
NAMES = ("x", "dt", "A", "B", "C", "D", "state0")
SHAPES = [(1, 50, 2, 8, 16), (2, 97, 3, 8, 16), (1, 128, 4, 16, 8)]  # (B, T, H, P, N)


def _inputs(shape, decay="normal", seed=0):
    """float64 numpy inputs (rounded to float32 values): dt after softplus,
    A negative, state0 and the two cotangents."""
    B, T, H, P, N = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P))
    if decay == "strong":
        dt = rng.uniform(0.5, 4.0, (B, T, H))
        A = np.full((H,), -16.0)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, H))))
        A = -np.abs(rng.standard_normal(H)) * (0.01 if decay == "weak" else 1.0)
    Bm, Cm = rng.standard_normal((B, T, N)), rng.standard_normal((B, T, N))
    D = rng.standard_normal(H)
    s0 = rng.standard_normal((B, H, P, N))
    dy, dh = rng.standard_normal((B, T, H, P)), rng.standard_normal((B, H, P, N))
    return [a.astype(np.float32).astype(np.float64) for a in (x, dt, A, Bm, Cm, D, s0, dy, dh)]


def _reference_grads(arrays, dtype):
    *ins, dy, dh = (jnp.asarray(a, dtype) for a in arrays)
    out, vjp = jax.vjp(lambda *a: _ssm_chunked.ssm_scan_chunked(*a), *ins)
    return out, vjp((dy.astype(out[0].dtype), dh.astype(out[1].dtype)))


def _port_grads(arrays, dtype):
    *ins, dy, dh = (torch.tensor(a, dtype=dtype) for a in arrays)
    ins = [t.requires_grad_() for t in ins]
    y, h = ops.ssm_scan(*ins)
    return (y, h), torch.autograd.grad([y, h], ins, [dy, dh.to(h.dtype)])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", [(s, "normal") for s in SHAPES] +
                         [(SHAPES[1], "strong"), (SHAPES[0], "weak")],
                         ids=lambda c: "x".join(map(str, c[0])) + f"_{c[1]}")
def test_gradient_matches_reference(case, dtype):
    shape, decay = case
    arrays = _inputs(shape, decay)
    if dtype == "float64":
        with reference_in_float64(_ssm_chunked):
            (want_y, want_h), want = _reference_grads(arrays, jnp.float64)
        tol = None
    else:
        (want_y, want_h), want = _reference_grads(arrays, jnp.float32)
        tol = F32_TOL
    (y, h), got = _port_grads(arrays, getattr(torch, dtype))
    assert y.dtype == h.dtype == getattr(torch, dtype)
    for name, g, w in zip(("y", "state") + NAMES, [y.detach(), h.detach(), *got],
                          [want_y, want_h, *want]):
        assert g.dtype == getattr(torch, dtype), name
        assert np.isfinite(g.numpy()).all(), name
        w = np.asarray(w)
        t = tol or dict(rtol=F64_RTOL, atol=F64_RTOL * np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, **t, err_msg=name)


@pytest.mark.parametrize("decay", ["normal", "strong"])
def test_kernel_chunk_matches_reference_chunk(decay):
    """The plain backward at K6b's 64-step chunk against it at the plain
    forward's 128, in float64, over three chunks."""
    *ins, dy, dh = (torch.tensor(a) for a in _inputs((2, 150, 3, 8, 16), decay, seed=1))
    at_64 = ssm_scan_bwd_plain(*ins, dy, dh, chunk=K6_CHUNK, acc_dtype=torch.float64)
    at_128 = ssm_scan_bwd_plain(*ins, dy, dh, acc_dtype=torch.float64)
    for name, a, b in zip(NAMES, at_64, at_128):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


def test_split_sequence_gradient_equals_whole():
    """Two halves with the state carried: the same gradients as one call."""
    *arrays, dy, dh = (torch.tensor(a) for a in _inputs((2, 97, 3, 8, 16), seed=2))

    def grads(split):
        ins = [t.clone().requires_grad_() for t in arrays]
        x, dt, A, Bm, Cm, D, s0 = ins
        if split is None:
            y, h = ops.ssm_scan(*ins)
        else:
            cut = slice(None, split), slice(split, None)
            y1, h1 = ops.ssm_scan(x[:, cut[0]], dt[:, cut[0]], A, Bm[:, cut[0]], Cm[:, cut[0]],
                                  D, s0)
            y2, h = ops.ssm_scan(x[:, cut[1]], dt[:, cut[1]], A, Bm[:, cut[1]], Cm[:, cut[1]],
                                 D, h1)
            y = torch.cat([y1, y2], dim=1)
        return torch.autograd.grad([y, h], ins, [dy, dh])

    for name, a, b in zip(NAMES, grads(40), grads(None)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


def test_gradcheck_and_the_cpu_path():
    """Finite differences in float64; `ssm_scan_bwd` on CPU tensors is the
    plain backward; a final state without a cotangent takes none; without
    state0 there is no dstate0; the scan called directly on CPU tensors
    stays differentiable (the plain forward)."""
    *ins, dy, dh = (torch.tensor(a) for a in _inputs((1, 9, 2, 3, 4), seed=3))
    leaves = [t.clone().requires_grad_() for t in ins]
    assert torch.autograd.gradcheck(lambda *a: SSMScan.apply(*a), leaves)
    x, dt, A, Bm, Cm, D, s0 = ins
    f32 = [t.float() for t in (x, dt, A, Bm, Cm, D)]
    got = ssm_scan_bwd(*f32, None, dy.float())
    want = ssm_scan_bwd_plain(*f32, None, dy.float())
    assert got[-1] is None and want[-1] is None
    for a, b in zip(got[:-1], want[:-1]):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in f32]
    y, _ = ops.ssm_scan(*leaves)
    g = torch.autograd.grad(y, leaves, dy.float())
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    y, _ = ssm_scan(*leaves)
    assert y.requires_grad


@pytest.mark.parametrize("drop_low", [False, True], ids=["split", "drop_low"])
@pytest.mark.parametrize("decay", ["strong", "normal"])
def test_split_model_matches_reference(decay, drop_low):
    """The tensor-core route's arithmetic against ``jax.vjp`` of the
    reference's chunked scan at 64 steps a chunk, in float64, on every
    gradient: T off the chunk, state0 and a final-state cotangent; dropping
    the low parts (the split's fault) fails the same check."""
    arrays = _inputs((2, 150, 3, 8, 16), decay, seed=5)
    *ins, dy, dh = (jnp.asarray(a, jnp.float64) for a in arrays)
    with reference_in_float64(_ssm_chunked):
        _, vjp = jax.vjp(lambda *a: _ssm_chunked.ssm_scan_chunked(*a, chunk=K6_CHUNK), *ins)
        want = vjp((dy, dh))
    got = ssm_scan_bwd_split_plain(*(torch.tensor(a, dtype=torch.float32) for a in arrays),
                                   drop_low=drop_low)
    errs = {}
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        w = np.asarray(w)
        errs[name] = np.linalg.norm(g.double().numpy() - w) / np.linalg.norm(w)
    assert all(e <= SPLIT_REL_L2 for e in errs.values()) != drop_low, errs


def test_routes():
    """K6b's route and head group: bf16 at P = N = 64 takes the tensor cores
    (as K6 does), everything else the first design; a body block takes a
    divisor of H up to 16 heads, 10 at Zamba2's training shape (256 blocks:
    one wave of 264)."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert bwd_route(bf16, 64, 64) == scan_route(bf16, 64, 64) == "tensor_core"
    for dtype, P, N in ((f32, 64, 64), (bf16, 128, 16), (f32, 128, 16)):
        assert bwd_route(dtype, P, N) == "fma_f32"
    assert bwd_group(2, 1024, 80) == 10
    for B, T, H in ((2, 300, 4), (1, 65, 3), (2, 4096, 80), (1, 64, 7), (8, 2048, 12)):
        g = bwd_group(B, T, H)
        assert 1 <= g <= 16 and H % g == 0, (B, T, H, g)
