"""The port's Mamba-2 scan (K6) against the reference's, on the CPU.

On the CPU `repro_torch.kernels.ssm_scan.ssm_scan` (and `ops.ssm_scan`)
runs the plain version `ssm_scan_plain`, the port of the reference's chunked
jnp form.  These tests hold it, and the sequential `ssm_scan_ref`, against
the Pallas kernel run as the reference's own tests run it
(`interpret=True`, block_t 32), against `ssm_scan_chunked` and against the
oracle `ref.ssm_scan`, on the same numpy inputs.  Tolerances are the
reference's (tests/test_kernels_scans.py:53-59): y float32 rtol = atol =
2e-4, bfloat16 5e-2; the final state (float32 in both dtypes) 1e-3.  bf16
inputs are the same float32 numbers rounded to bfloat16 by each framework
(round to nearest even in both).  The CUDA kernel is held against these
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.

`ssm_scan_split_plain` models the arithmetic of K6's bf16 tensor-core route
(64-step chunks; each float32 operand of a product, the state, G and
ws o x, fed as a bf16 high part plus a bf16 low part): it is held to the
same reference tolerances, and to within 2e-5 in relative L2 of the plain
version's state, the size the split leaves (~2^-16 a product, summed);
without the low parts (the route's planted fault) the state moves by ~2^-9
relative and leaves the 1e-3 state tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels._ssm_chunked import ssm_scan_chunked  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssm_scan,
    ssm_scan_plain,
    ssm_scan_ref,
    ssm_scan_split_plain,
)

Y_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)

# (B, T, H, P, N): T off Pallas's 32-step block and off the plain version's
# 128-step chunk (150), the reduced zamba2's P 128 / N 16, one step.
CASES = [(1, 50, 2, 8, 16), (2, 150, 3, 8, 16), (1, 70, 2, 128, 16), (2, 1, 2, 16, 8)]


def _inputs(shape, *, strong=False, seed=0):
    """float32 numpy inputs: dt after softplus, A negative (with ``strong``:
    A = -16 and dt in [0.5, 4], so every step decays the state by e^-8 or
    more), state0."""
    B, T, H, P, N = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    if strong:
        dt = rng.uniform(0.5, 4.0, (B, T, H)).astype(np.float32)
        A = np.full((H,), -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
        A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, s0


def _both(arrays, dtype):
    """(jax, torch) operand lists; x, B and C in ``dtype``, the rest float32."""
    x, dt, A, Bm, Cm, D = arrays
    low = {0, 3, 4}
    j = [jnp.asarray(a, getattr(jnp, dtype) if i in low else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype) if i in low else torch.float32)
         for i, a in enumerate(arrays)]
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.fixture(autouse=True)
def _no_launches():
    ssm_scan.launches = 0
    yield
    assert ssm_scan.launches == 0  # CPU: the plain version only


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "state0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "x".join(map(str, s)))
def test_plain_and_sequential_match_reference(shape, dtype, with_state):
    *arrays, s0 = _inputs(shape)
    (jx, *jrest), (tx, *trest) = _both(arrays, dtype)
    js0, ts0 = (jnp.asarray(s0), torch.from_numpy(s0)) if with_state else (None, None)
    want_y, want_h = ref.ssm_scan(jx, *jrest, state0=js0)
    pallas_y, pallas_h = pallas_ssm(jx, *jrest, state0=js0, block_t=32, interpret=True)
    chunked_y, chunked_h = ssm_scan_chunked(jx, *jrest, state0=js0)
    for fn in (ssm_scan_plain, ssm_scan_ref, ssm_scan, ops.ssm_scan):
        y, h = fn(tx, *trest, ts0)
        assert y.shape == tx.shape and y.dtype == tx.dtype and h.dtype == torch.float32
        for wy, wh, against in ((want_y, want_h, "ref.ssm_scan"),
                                (pallas_y, pallas_h, "the Pallas kernel"),
                                (chunked_y, chunked_h, "ssm_scan_chunked")):
            msg = f"{fn.__name__} against {against}"
            np.testing.assert_allclose(_np(y), _np(wy), **Y_TOL[dtype], err_msg=msg)
            np.testing.assert_allclose(h.numpy(), np.asarray(wh), **STATE_TOL, err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strong_decay_gives_no_nan(dtype):
    """A = -16 with dt in [0.5, 4]: within a chunk exp(cum[t] - cum[s]) for s > t
    would overflow to inf; the masked exponent keeps every value finite.

    dt starts at 0.5: with dt near 0 beside |cum| ~ 1e4 the chunked form's
    exponent loses ~|cum| 2^-24 to cancellation, the reference's own chunked
    form then differs from its oracle by 0.77 of the 2e-4 tolerance, and the
    case would measure that conditioning instead of the overflow."""
    *arrays, s0 = _inputs((2, 200, 2, 8, 16), strong=True, seed=1)
    (jx, *jrest), (tx, *trest) = _both(arrays, dtype)
    want_y, want_h = ref.ssm_scan(jx, *jrest, state0=jnp.asarray(s0))
    for fn in (ssm_scan_plain, ssm_scan_ref):
        y, h = fn(tx, *trest, torch.from_numpy(s0))
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
        np.testing.assert_allclose(_np(y), _np(want_y), **Y_TOL[dtype])
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **STATE_TOL)


def test_plain_reads_strided_operands():
    """x, B and C as column slices of one tensor (as `mamba_apply` hands
    them): the same result as from contiguous copies."""
    B, T, H, P, N = 2, 70, 2, 8, 16
    *arrays, _ = _inputs((B, T, H, P, N), seed=2)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in arrays)
    packed = torch.cat([x.reshape(B, T, H * P), Bm, Cm], dim=-1)
    xs, Bs, Cs = torch.split(packed, [H * P, N, N], dim=-1)
    assert not xs.is_contiguous()
    got = ssm_scan_plain(xs.view(B, T, H, P), dt, A, Bs, Cs, D)
    want = ssm_scan_plain(x, dt, A, Bm, Cm, D)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


SPLIT_CASES = CASES + [(1, 150, 2, 64, 64)]  # the route's own (P, N), off the 64-step chunk


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "state0"])
@pytest.mark.parametrize("shape", SPLIT_CASES, ids=lambda s: "x".join(map(str, s)))
def test_split_model_matches_reference(shape, with_state):
    """The tensor-core route's model (bf16 operands, as the route takes them)
    against the oracle, the Pallas kernel in interpret mode and
    `ssm_scan_chunked`, at the reference's bf16 and state tolerances."""
    *arrays, s0 = _inputs(shape, seed=3)
    (jx, *jrest), (tx, *trest) = _both(arrays, "bfloat16")
    js0, ts0 = (jnp.asarray(s0), torch.from_numpy(s0)) if with_state else (None, None)
    y, h = ssm_scan_split_plain(tx, *trest, ts0)
    assert y.shape == tx.shape and y.dtype == tx.dtype and h.dtype == torch.float32
    for wy, wh, against in ((*ref.ssm_scan(jx, *jrest, state0=js0), "ref.ssm_scan"),
                            (*pallas_ssm(jx, *jrest, state0=js0, block_t=32, interpret=True),
                             "the Pallas kernel"),
                            (*ssm_scan_chunked(jx, *jrest, state0=js0), "ssm_scan_chunked")):
        msg = f"ssm_scan_split_plain against {against}"
        np.testing.assert_allclose(_np(y), _np(wy), **Y_TOL["bfloat16"], err_msg=msg)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), **STATE_TOL, err_msg=msg)


@pytest.mark.parametrize("strong", [False, True], ids=["init_decay", "strong_decay"])
def test_split_model_keeps_float32_accuracy(strong):
    """The split leaves the state within 2e-5 of the plain version's (relative
    L2) and finite under strong decay; dropping the low parts (the route's
    planted fault) moves it past the 1e-3 state tolerance."""
    *arrays, s0 = _inputs((1, 256, 4, 64, 64), strong=strong, seed=4)
    _, t = _both(arrays, "bfloat16")
    ts0 = torch.from_numpy(s0)
    y_p, h_p = ssm_scan_plain(*t, ts0)
    y, h = ssm_scan_split_plain(*t, ts0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    assert _rel(h, h_p) <= 2e-5
    torch.testing.assert_close(h, h_p, **STATE_TOL)
    _, h_fault = ssm_scan_split_plain(*t, ts0, drop_low=True)
    assert _rel(h_fault, h_p) > 1e-4
    with pytest.raises(AssertionError):
        torch.testing.assert_close(h_fault, h_p, **STATE_TOL)
