"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a card: the kernels have no
CPU mode.  The file imports only torch and `repro_torch`, so it runs on a
machine without JAX; there, run it without the suite's JAX conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's (tests/test_kernels_prox.py): prox_update f32
1e-6 / f64 1e-12; logistic f32 rtol 1e-5 atol 1e-6 / f64 rtol 1e-12 atol 1e-13.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.logistic_prox import (  # noqa: E402
    logistic_prox_gd_batched,
    logistic_prox_gd_batched_plain,
)
from repro_torch.kernels.prox_update import (  # noqa: E402
    prox_update_batched,
    prox_update_batched_plain,
)

K1_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}
K2_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=1e-13)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    prox_update_batched.launches = 0
    logistic_prox_gd_batched.launches = 0
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("scalar", [False, True], ids=["per_row", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 40), (3, 37, 11), (7, 1), (64, 123)])
def test_prox_update_kernel_matches_plain(cuda, shape, dtype, scalar):
    gen = torch.Generator().manual_seed(0)
    y, g, z = (_randn(gen, shape, dtype, cuda) for _ in range(3))
    R = shape[0]
    if scalar:
        lr, inv_eta = 0.1, 2.0
    else:
        lr = torch.linspace(0.01, 0.9, R, dtype=dtype, device=cuda)
        inv_eta = torch.linspace(0.5, 4.0, R, dtype=dtype, device=cuda)
    out = prox_update_batched(y, g, z, lr, inv_eta)
    torch.cuda.synchronize()
    assert prox_update_batched.launches == 1
    assert out.shape == y.shape and out.dtype == dtype and out.is_cuda
    torch.testing.assert_close(out, prox_update_batched_plain(y, g, z, lr, inv_eta), **K1_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("with_y0", [False, True], ids=["y0_absent", "y0_given"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 17, 5), (3, 100, 123), (2, 2000, 600), (1, 9, 700)])
def test_logistic_prox_kernel_matches_plain(cuda, shape, dtype, with_y0):
    """Ragged n and d, d above the block's 512 threads, y0 given or absent."""
    gen = torch.Generator().manual_seed(1)
    R, n, d = shape
    A = _randn(gen, shape, dtype, cuda) * 0.2
    z = _randn(gen, (R, d), dtype, cuda)
    y0 = _randn(gen, (R, d), dtype, cuda) if with_y0 else None
    beta = torch.linspace(0.02, 0.3, R, dtype=dtype, device=cuda)
    inv_eta = torch.linspace(0.5, 3.0, R, dtype=dtype, device=cuda)
    out = logistic_prox_gd_batched(A, z, beta, inv_eta, 0.1, 9, y0=y0)
    torch.cuda.synchronize()
    assert logistic_prox_gd_batched.launches == 1
    assert out.shape == (R, d) and out.dtype == dtype
    want = logistic_prox_gd_batched_plain(A, z, beta, inv_eta, 0.1, 9, y0)
    torch.testing.assert_close(out, want, **K2_TOL[dtype])


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    y = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        prox_update_batched(y.half(), y.half(), y.half(), 0.1, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        prox_update_batched(y.t(), y.t(), y.t(), 0.1, 2.0)
    with pytest.raises(ValueError, match="share one"):
        prox_update_batched(y, y[:2], y, 0.1, 2.0)
    A = torch.zeros((2, 30000, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        logistic_prox_gd_batched(A, torch.zeros((2, 8), dtype=torch.float64, device=cuda),
                                 0.1, 2.0, 0.1, 3)
    assert prox_update_batched.launches == 0 and logistic_prox_gd_batched.launches == 0


@pytest.mark.gpu
def test_main_path_goes_through_the_kernels(cuda):
    """A small fused sweep on the card launches both kernels and agrees with
    the same sweep on the CPU (same native draws)."""
    from repro_torch.core import draw_schedule
    from repro_torch.experiments import run_batch
    from repro_torch.problems import make_a9a_like_problem, make_synthetic_quadratic

    def quadratic(dev):
        return make_synthetic_quadratic(10, 6, L=80.0, delta=4.0, seed=1, device=dev)

    def logistic(dev):
        return make_a9a_like_problem(6, 40, n_pool=300, dim=12, nnz_per_row=4, seed=1, device=dev)

    for make, M, steps in ((quadratic, 10, 20), (logistic, 6, 10)):
        draws = draw_schedule([0, 0, 1, 1], M, 30, 0.2)
        kw = dict(grid={"eta": [0.1, 0.05], "p": 0.2, "smoothness": 80.0}, seeds=2, fused=True,
                  num_steps=30, prox_solver="gd", prox_steps=steps, draws=draws)
        gpu, cpu = run_batch("svrp", make("cuda"), **kw), run_batch("svrp", make("cpu"),
                                                                   device="cpu", **kw)
        assert torch.equal(gpu.comm.cpu(), cpu.comm)
        torch.testing.assert_close(gpu.dist_sq.cpu(), cpu.dist_sq, rtol=1e-9, atol=0.0)
    assert prox_update_batched.launches == 20 * 30
    assert logistic_prox_gd_batched.launches == 30
