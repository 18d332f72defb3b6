"""The port's kernels (`repro_torch.kernels`) against the reference's.

On the CPU each wrapper runs its plain PyTorch version; these tests hold that
plain version against the reference oracle (`repro.kernels.ref`) and the
Pallas kernels in interpret mode, on the same numpy inputs, at the
reference's own tolerances (tests/test_kernels_prox.py): prox_update f32
1e-6 / f64 1e-12; logistic f32 rtol 1e-5 atol 1e-6 / f64 rtol 1e-12 atol
1e-13.  The CUDA kernels themselves are held against the plain versions on
the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.logistic_prox import logistic_prox_gd_batched as pallas_logistic  # noqa: E402
from repro.kernels.prox_update import prox_update_batched as pallas_prox_b  # noqa: E402
from repro_torch.kernels.logistic_prox import (  # noqa: E402
    logistic_prox_gd_batched,
    logistic_prox_gd_batched_plain,
    logistic_prox_gd_indexed,
    logistic_prox_gd_indexed_plain,
)
from repro_torch.kernels.prox_update import prox_update_batched  # noqa: E402

K1_TOL = {np.float32: dict(rtol=1e-6, atol=1e-6), np.float64: dict(rtol=1e-12, atol=0.0)}
K2_TOL = {np.float32: dict(rtol=1e-5, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-13)}


def _k1_inputs(shape, dtype, per_row, seed=0):
    rng = np.random.default_rng(seed)
    y, g, z = (rng.standard_normal(shape).astype(dtype) for _ in range(3))
    B = shape[0]
    if per_row:
        lr = np.linspace(0.01, 0.9, B).astype(dtype)
        inv_eta = np.linspace(0.5, 4.0, B).astype(dtype)
    else:
        lr, inv_eta = dtype(0.1), dtype(2.0)
    return y, g, z, lr, inv_eta


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    prox_update_batched.launches = 0
    logistic_prox_gd_batched.launches = 0
    yield


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(4, 7), (3, 37, 11), (5, 300), (6,), (16, 40)])
def test_prox_update_batched_matches_reference(shape, dtype, per_row):
    y, g, z, lr, inv_eta = _k1_inputs(shape, dtype, per_row)
    got = prox_update_batched(_t(y), _t(g), _t(z), _t(lr), _t(inv_eta)).numpy()
    oracle = np.asarray(ref.prox_update_batched(*(jnp.asarray(a) for a in (y, g, z, lr, inv_eta))))
    pallas = np.asarray(pallas_prox_b(*(jnp.asarray(a) for a in (y, g, z, lr, inv_eta))))
    assert got.shape == shape and got.dtype == dtype
    np.testing.assert_allclose(got, oracle, **K1_TOL[dtype])
    np.testing.assert_allclose(got, pallas, **K1_TOL[dtype])
    assert prox_update_batched.launches == 0  # CPU tensors take the plain version


def test_prox_update_batched_python_scalars():
    y, g, z, _, _ = _k1_inputs((3, 40), np.float64, False, seed=1)
    got = prox_update_batched(_t(y), _t(g), _t(z), 0.1, 2.0).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.prox_update(y, g, z, 0.1, 2.0)), rtol=1e-12)


def _k2_inputs(shape, dtype, with_y0, seed=4):
    B, n, d = shape
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape).astype(dtype)
    z = rng.standard_normal((B, d)).astype(dtype)
    y0 = rng.standard_normal((B, d)).astype(dtype) if with_y0 else None
    beta = np.linspace(0.02, 0.3, B).astype(dtype)
    inv_eta = np.linspace(0.5, 3.0, B).astype(dtype)
    return A, z, y0, beta, inv_eta


@pytest.mark.parametrize("with_y0", [False, True], ids=["y0_absent", "y0_given"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(2, 17, 5), (4, 64, 16), (3, 33, 13)])
def test_logistic_prox_gd_batched_matches_reference(shape, dtype, with_y0):
    """Ragged n and d (no multiple of 8 or 128), per-row scalars, y0 given or not."""
    A, z, y0, beta, inv_eta = _k2_inputs(shape, dtype, with_y0)
    steps, lam = 9, 0.1
    got = logistic_prox_gd_batched(
        _t(A), _t(z), _t(beta), _t(inv_eta), lam, steps, y0=None if y0 is None else _t(y0)
    ).numpy()
    j = [jnp.asarray(a) for a in (A, z, beta, inv_eta)]
    jy0 = None if y0 is None else jnp.asarray(y0)
    oracle = np.asarray(ref.logistic_prox_gd_batched(*j, lam, steps, y0=jy0))
    pallas = np.asarray(pallas_logistic(*j, lam, steps, y0=jy0))
    assert got.shape == (shape[0], shape[2]) and got.dtype == dtype
    np.testing.assert_allclose(got, oracle, **K2_TOL[dtype])
    np.testing.assert_allclose(got, pallas, **K2_TOL[dtype])
    assert logistic_prox_gd_batched.launches == 0


def test_logistic_prox_scalar_operands():
    A, z, _, _, _ = _k2_inputs((3, 20, 7), np.float64, False, seed=5)
    got = logistic_prox_gd_batched(_t(A), _t(z), 0.1, 2.0, 0.05, 6).numpy()
    oracle = np.asarray(ref.logistic_prox_gd_batched(jnp.asarray(A), jnp.asarray(z), 0.1, 2.0, 0.05, 6))
    np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("kernel", ["prox_update_batched", "logistic_prox_gd_batched",
                                    "logistic_prox_gd_indexed"])
def test_non_cpu_tensor_launches_or_raises(kernel):
    """A tensor off the CPU never takes the plain version: on a device the
    kernel does not take (here `meta`) the wrapper raises and counts nothing."""
    if kernel == "prox_update_batched":
        y = torch.empty((4, 8), dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            prox_update_batched(y, y, y, 0.1, 2.0)
        assert prox_update_batched.launches == 0
    elif kernel == "logistic_prox_gd_batched":
        A = torch.empty((2, 5, 3), dtype=torch.float64, device="meta")
        z = torch.empty((2, 3), dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            logistic_prox_gd_batched(A, z, 0.1, 2.0, 0.1, 3)
        assert logistic_prox_gd_batched.launches == 0
    else:
        Z = torch.empty((4, 5, 3), dtype=torch.float64, device="meta")
        y = torch.empty((4, 5), dtype=torch.float64, device="meta")
        m = torch.zeros((2,), dtype=torch.int64, device="meta")
        z = torch.empty((2, 3), dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            logistic_prox_gd_indexed(Z, y, m, z, 0.1, 2.0, 0.1, 3)
        assert logistic_prox_gd_batched.launches == 0


def _k2_clients(M, n, d, R, dtype, seed=6):
    """Client features Z (M, n, d), labels y (M, n) in {-1, 1}, the rows'
    clients m (R,), targets z and starts y0 (R, d), per-row beta and inv_eta."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((M, n, d)).astype(dtype)
    y = rng.choice(np.array([-1.0, 1.0], dtype=dtype), size=(M, n))
    m = rng.integers(0, M, size=R)
    z, y0 = (rng.standard_normal((R, d)).astype(dtype) for _ in range(2))
    beta = np.linspace(0.02, 0.3, R).astype(dtype)
    inv_eta = np.linspace(0.5, 3.0, R).astype(dtype)
    return Z, y, m, z, y0, beta, inv_eta


@pytest.mark.parametrize("with_y0", [False, True], ids=["y0_absent", "y0_given"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_logistic_indexed_equals_the_gathered_rows_bit_for_bit(dtype, with_y0):
    """The sweep's entry on the CPU: the sampled clients' label-signed rows
    Z[m] * y[m], gathered as the sweep gathered them before, then the plain
    loop; the same bits as the plain loop on those rows."""
    Z, y, m, z, y0, beta, inv_eta = _k2_clients(5, 19, 7, 6, dtype)
    tZ, ty, tm = _t(Z), _t(y), torch.from_numpy(m)
    ty0 = _t(y0) if with_y0 else None
    got = logistic_prox_gd_indexed(tZ, ty, tm, _t(z), _t(beta), _t(inv_eta), 0.1, 9, y0=ty0)
    want = logistic_prox_gd_batched_plain(tZ[tm] * ty[tm][..., None], _t(z), _t(beta),
                                          _t(inv_eta), 0.1, 9, ty0)
    assert got.dtype == tZ.dtype and got.shape == (6, 7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = logistic_prox_gd_indexed_plain(tZ, ty, tm, _t(z), _t(beta), _t(inv_eta), 0.1, 9, ty0)
    torch.testing.assert_close(plain, want, rtol=0, atol=0)
    assert logistic_prox_gd_batched.launches == 0


@pytest.mark.parametrize("shape", [(4, 17, 5, 3), (3, 33, 13, 8), (2, 1, 7, 4), (6, 40, 123, 5)],
                         ids=lambda s: "M{}_n{}_d{}_R{}".format(*s))
def test_logistic_indexed_matches_reference(shape):
    """Against the reference's Pallas K2 (interpret mode) and its oracle on
    the same signed rows, float64 at rtol 1e-12 / atol 1e-13: ragged n and d
    (no multiple of 8 or 128), one client row, a client drawn twice."""
    M, n, d, R = shape
    Z, y, m, z, y0, beta, inv_eta = _k2_clients(M, n, d, R, np.float64, seed=M + n)
    steps, lam = 9, 0.1
    got = logistic_prox_gd_indexed(_t(Z), _t(y), torch.from_numpy(m), _t(z), _t(beta),
                                   _t(inv_eta), lam, steps, y0=_t(y0)).numpy()
    A = Z[m] * y[m][..., None]
    j = [jnp.asarray(a) for a in (A, z, beta, inv_eta)]
    pallas = np.asarray(pallas_logistic(*j, lam, steps, y0=jnp.asarray(y0)))
    oracle = np.asarray(ref.logistic_prox_gd_batched(*j, lam, steps, y0=jnp.asarray(y0)))
    np.testing.assert_allclose(got, pallas, **K2_TOL[np.float64])
    np.testing.assert_allclose(got, oracle, **K2_TOL[np.float64])
