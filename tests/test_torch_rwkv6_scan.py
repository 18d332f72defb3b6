"""The port's RWKV-6 WKV scan (K7) against the reference's, on the CPU.

On the CPU `repro_torch.kernels.rwkv6_scan.rwkv6_scan` (and
`ops.rwkv6_scan`) runs the plain version `rwkv6_scan_plain`, the port of
the reference's oracle.  These tests hold it against that oracle
`ref.rwkv6_scan` and against the Pallas kernel run as the reference's own
tests run it (interpret mode, block_t 16), on the same numpy inputs, at the
reference's shapes and tolerances (tests/test_kernels_scans.py:11-35): y
float32 rtol = atol = 1e-4, bfloat16 5e-2; the final state (float32 in both
dtypes) 1e-3.  bf16 inputs are the same float32 numbers rounded to bfloat16
by each framework (round to nearest even in both).  The CUDA kernel is held
against the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    _check,
    _packed,
    rwkv6_scan,
    rwkv6_scan_plain,
)

Y_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
RWKV_SHAPES = [(1, 33, 2, 8), (2, 100, 3, 16), (1, 64, 4, 32)]  # (B, T, H, K): the reference's
DECAYS = {"sigmoid": None, "strong": (0.03, 0.07), "weak": (0.998, 0.9999)}


def _inputs(shape, decay="sigmoid", seed=0):
    """float32 numpy r, k, v, w, u, state0; w = sigmoid(normal) as the
    reference's tests draw it, or uniform in a strong- or weak-decay band."""
    B, T, H, K = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) for _ in range(3))
    if DECAYS[decay] is None:
        w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, K))))).astype(np.float32)
    else:
        w = rng.uniform(*DECAYS[decay], (B, T, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, w, u, s0


def _both(arrays, dtype):
    """(jax, torch) operands: r, k, v, w in ``dtype``, u float32."""
    r, k, v, w, u = arrays
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in (r, k, v, w)] + [jnp.asarray(u)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (r, k, v, w)]
    return j, t + [torch.from_numpy(u)]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.fixture(autouse=True)
def _no_launches():
    rwkv6_scan.launches = 0
    yield
    assert rwkv6_scan.launches == 0  # CPU: the plain version only


def _assert_matches(shape, dtype, with_state, decay="sigmoid", seed=0):
    *arrays, s0 = _inputs(shape, decay, seed)
    j, t = _both(arrays, dtype)
    js0, ts0 = (jnp.asarray(s0), torch.from_numpy(s0)) if with_state else (None, None)
    want_y, want_s = ref.rwkv6_scan(*j, state0=js0)
    pallas_y, pallas_s = pallas_rwkv6(*j, state0=js0, block_t=16)
    for fn in (rwkv6_scan_plain, rwkv6_scan, ops.rwkv6_scan):
        y, S = fn(*t, ts0)
        assert y.shape == t[2].shape and y.dtype == t[0].dtype and S.dtype == torch.float32
        for wy, ws, against in ((want_y, want_s, "ref.rwkv6_scan"),
                                (pallas_y, pallas_s, "the Pallas kernel")):
            msg = f"{fn.__name__} against {against}"
            np.testing.assert_allclose(_np(y), _np(wy), **Y_TOL[dtype], err_msg=msg)
            np.testing.assert_allclose(S.numpy(), np.asarray(ws), **STATE_TOL, err_msg=msg)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "state0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RWKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_and_pallas(shape, dtype, with_state):
    """The reference's shapes: T off Pallas's 16-step block (33, 100) and on it (64)."""
    _assert_matches(shape, dtype, with_state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_strong_and_weak_decay(decay, dtype):
    """w near 0.05 (the state forgets within a step or two) and near 0.999
    (it sums nearly all 100 steps), T off the block, with a state0."""
    _assert_matches((2, 100, 2, 16), dtype, True, decay, seed=1)


def test_split_state_carry_composes():
    """Two halves with the carried state equal one run (the decode contract),
    within 1e-5 as the reference's test_rwkv_state_carry_composes."""
    *arrays, _ = _inputs((1, 40, 2, 8), seed=2)
    _, (r, k, v, w, u) = _both(arrays, "float32")
    y_full, S_full = rwkv6_scan_plain(r, k, v, w, u)
    y1, S1 = rwkv6_scan_plain(r[:, :20], k[:, :20], v[:, :20], w[:, :20], u)
    y2, S2 = rwkv6_scan_plain(r[:, 20:], k[:, 20:], v[:, 20:], w[:, 20:], u, S1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, rtol=0, atol=1e-5)
    torch.testing.assert_close(S2, S_full, rtol=0, atol=1e-5)
    # and one step at a time, as decode runs it
    S, ys = None, []
    for t in range(40):
        y_t, S = rwkv6_scan(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], w[:, t:t + 1], u, S)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, rtol=0, atol=1e-5)
    torch.testing.assert_close(S, S_full, rtol=0, atol=1e-5)


@pytest.mark.parametrize("alias", [False, True], ids=["own_output", "state0_as_output"])
def test_out_state_takes_the_final_state(alias):
    """The final state written into ``out_state``, which may be state0 itself
    (decode steps each layer's state in place): the same y and state as a
    call that returns a new state, and state0 untouched unless it is the
    output."""
    *arrays, s0 = _inputs((2, 7, 3, 16), seed=3)
    _, (r, k, v, w, u) = _both(arrays, "float32")
    s0 = torch.from_numpy(s0)
    want_y, want_s = rwkv6_scan(r, k, v, w, u, s0)
    state0 = s0.clone()
    out = state0 if alias else torch.full_like(s0, float("nan"))
    y, S = ops.rwkv6_scan(r, k, v, w, u, state0, out_state=out)
    assert S is out
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(out, want_s, rtol=0, atol=0)
    if not alias:
        torch.testing.assert_close(state0, s0, rtol=0, atol=0)


def test_check_refuses_what_k7_does_not_take():
    """The operand checks that come before the device check (the rest need
    CUDA tensors and run on the card, tests/test_torch_gpu.py)."""
    *arrays, s0 = _inputs((1, 5, 2, 16))
    _, (r, k, v, w, u) = _both(arrays, "float32")
    with pytest.raises(ValueError, match="not built"):
        _check("rwkv6_scan", r[..., :12], k[..., :12], v[..., :12], w[..., :12], u[:, :12], None)
    with pytest.raises(ValueError, match="not built"):
        _check("rwkv6_scan", r, k, v[..., :8], w, u, None)
    with pytest.raises(ValueError, match=r"\(B, T, H, K\)"):
        _check("rwkv6_scan", r, k[:, :4], v, w, u, None)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _check("rwkv6_scan", r.double(), k.double(), v.double(), w.double(), u, None)
    with pytest.raises(TypeError, match="r's dtype"):
        _check("rwkv6_scan", r, k, v, w.bfloat16(), u, None)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _check("rwkv6_scan", r, k, v, w, u, torch.from_numpy(s0))


def _scalar_bonus_scan(r, k, v, w, u, s0):
    """The algebra K7 runs (csrc/rwkv6_scan.cu), in float64: the bonus as
    one scalar a step, y_t = S^T r_t + beta_t v_t with
    beta_t = sum_k r_t[k] u[k] k_t[k], then S = diag(w_t) S + k_t v_t^T."""
    r, k, v, w, u, S = (a.double() for a in (r, k, v, w, u, s0))
    ys = []
    for t in range(r.shape[1]):
        beta = (r[:, t] * u * k[:, t]).sum(-1)  # (B, H)
        ys.append(torch.einsum("bhkv,bhk->bhv", S, r[:, t]) + beta[..., None] * v[:, t])
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(ys, dim=1), S


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("shape", RWKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scalar_bonus_algebra_equals_the_plain_scan(shape, decay):
    """K7 forms the bonus u o (k v^T) read by r as v_t times one scalar a
    step (5 K V operations a step where the plain scan's 7); in float64
    that is the plain scan's function to 1e-12, from a state0."""
    *arrays, s0 = _inputs(shape, decay, seed=5)
    r, k, v, w, u = (torch.from_numpy(a).double() for a in arrays)
    s0 = torch.from_numpy(s0).double()
    y, S = _scalar_bonus_scan(r, k, v, w, u, s0)
    want_y, want_S = rwkv6_scan_plain(r, k, v, w, u, s0, acc_dtype=torch.float64)
    torch.testing.assert_close(y, want_y, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(S, want_S, rtol=1e-12, atol=1e-12)


def test_packed_dims_are_what_the_kernel_reads():
    """The wrapper hands K7 its shapes and strides in one array, read by
    `rwkv6_scan_fwd` as is_bf16, B, T, H, K, then r's, k's, v's and w's
    strides in (b, t, h, k) order; column views of one tensor keep theirs."""
    B, T, H, K = 2, 5, 3, 8
    packed = torch.zeros((B, T, 4 * H * K), dtype=torch.bfloat16)
    r, k, v, w = (packed[..., i * H * K:(i + 1) * H * K].view(B, T, H, K) for i in range(4))
    dims = list(_packed(r, k, v, w))
    assert dims[:5] == [1, B, T, H, K]
    assert dims[5:] == [T * 4 * H * K, 4 * H * K, K, 1] * 4
    assert list(_packed(*(t.float().contiguous() for t in (r, k, v, w))))[:6] == [0, B, T, H, K,
                                                                              T * H * K]
