"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a card: the kernels have no
CPU mode.  The file imports only torch and `repro_torch`, so it runs on a
machine without JAX; there, run it without the suite's JAX conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the reference's (tests/test_kernels_prox.py): prox_update f32
1e-6 / f64 1e-12; logistic f32 rtol 1e-5 atol 1e-6 / f64 rtol 1e-12 atol 1e-13;
K1's loop form (a whole quadratic solve in one launch) f32 rtol = atol = 1e-4,
f64 1e-11: its update rounds as K1's does, but each step's matvec sums in
another order than the plain version's cuBLAS, an error of about one unit
roundoff of |y| a step (beta ~ 1/L cancels A's scale), which the contracting
iteration carries at most STEPS times (2.4e-5 in f32, 4.4e-14 in f64 at 200);
flash attention f32 2e-5 / bf16 2e-2 (tests/test_kernels_attention.py:_tol);
decode attention f32 2e-5 / bf16 3e-2 (tests/test_kernels_decode.py), and
with a bf16 operand also max abs <= 2^-7 max|plain| and relative L2 <= 2^-7
(the most two bf16 roundings of one float32 result can differ), as
chip_smoke.py holds it: 3e-2 alone is the size of the output at S ~ 1000.
The tree step K3: f32 rtol 1e-6, bf16 2e-2, f64 rtol 1e-12
(tests/test_kernels_prox.py:146-177).  K4's log-sum-exp within 1e-5 of the
plain one on every row that sees a key.  The attention backward K4b: f32
atol 5e-5, rtol 5e-4 (the reference's gradient tolerance,
tests/test_kernels_attention.py:59-78); bf16 max abs <= 2e-2 max|plain| and
relative L2 <= 2e-2 on each of dq, dk, dv.  The Mamba-2 scan K6: y f32
rtol = atol = 2e-4, bf16 5e-2, the final state 1e-3
(tests/test_kernels_scans.py:53-59).  The RWKV-6 scan K7: y f32 rtol = atol =
1e-4, bf16 5e-2, the final state 1e-3 (tests/test_kernels_scans.py:27-35);
bf16 element by element, float32 in relative L2 against the plain version
and against a float64 recurrence, as chip_smoke.py holds it: under weak
decay (w near 0.999, 300 steps) |y| reaches ~100, and two right float32
results differ by ~1.5e-4 at elements near zero, more than 1e-4 + 1e-4 |y|.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)
from repro_torch.kernels import flash_attention as fa_module  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels import logistic_prox as k2_module  # noqa: E402
from repro_torch.kernels.logistic_prox import (  # noqa: E402
    logistic_prox_gd_batched,
    logistic_prox_gd_batched_plain,
    logistic_prox_gd_indexed,
    logistic_prox_gd_indexed_plain,
)
from repro_torch.kernels.prox_update import (  # noqa: E402
    prox_update,
    prox_update_batched,
    prox_update_batched_plain,
    prox_update_plain,
    quadratic_prox_gd_batched,
    quadratic_prox_gd_batched_plain,
)
from repro_torch.kernels import rwkv6_scan as rwkv_module  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    rwkv6_scan,
    rwkv6_scan_bwd,
    rwkv6_scan_bwd_plain,
    rwkv6_scan_plain,
)
from repro_torch.kernels import ssm_scan as ssm_module  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssm_scan,
    ssm_scan_bwd,
    ssm_scan_bwd_plain,
    ssm_scan_plain,
    ssm_scan_ref,
)

K1_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=0.0)}
K2_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=1e-13)}
K1_LOOP_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
               torch.float64: dict(rtol=1e-11, atol=1e-11)}
K4_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
K5_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
K5_BF16_SCALED = 2.0**-7
K3_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6), torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
          torch.float64: dict(rtol=1e-12, atol=0.0)}
K4_LSE_ATOL = 1e-5
K4B_F32_TOL = dict(rtol=5e-4, atol=5e-5)
K4B_BF16_REL = 2e-2
K6_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
K6_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
K7_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
K7_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# The scan backwards K6b and K7b against their plain versions: relative L2
# on every gradient (chip_smoke.py's K6B_REL_TOL and K7B_REL_TOL).
K6B_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
K7B_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    prox_update_batched.launches = quadratic_prox_gd_batched.launches = 0
    logistic_prox_gd_batched.launches = 0
    flash_attention.launches = decode_attention.launches = 0
    prox_update.launches = flash_attention_bwd.launches = 0
    ssm_scan.launches = rwkv6_scan.launches = 0
    ssm_scan_bwd.launches = rwkv6_scan_bwd.launches = 0
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


def _spd_clients(gen, M, d, dtype, device):
    """M symmetric positive definite (d, d) matrices with spectra in [1, 200]."""
    q, _ = torch.linalg.qr(torch.randn((M, d, d), generator=gen, dtype=torch.float64))
    eigs = torch.exp(torch.rand((M, 1, d), generator=gen, dtype=torch.float64) * 5.3)
    A = (q * eigs) @ q.transpose(1, 2)
    return (0.5 * (A + A.transpose(1, 2))).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("with_y0", [False, True], ids=["y0_absent", "y0_given"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,d", [(16, 40), (64, 40), (5, 200), (3, 7)])
def test_quadratic_prox_loop_kernel_matches_plain(cuda, rows, d, dtype, with_y0):
    """fig-1 svrp (R 16) and minibatch (R 64) at d 40; d 200, whose A does
    not fit in shared memory in f64 (it is read from global memory there);
    a d below one warp's lanes."""
    gen = torch.Generator().manual_seed(5)
    M, steps = 50, 200
    A = _spd_clients(gen, M, d, dtype, cuda)
    b = _randn(gen, (M, d), dtype, cuda)
    m = torch.randint(0, M, (rows,), generator=gen).to(cuda)
    z = _randn(gen, (rows, d), dtype, cuda)
    y0 = _randn(gen, (rows, d), dtype, cuda) if with_y0 else None
    eta = torch.linspace(0.01, 0.5, rows, dtype=dtype, device=cuda)
    beta, inv_eta = 1.0 / (200.0 + 1.0 / eta), 1.0 / eta
    out = quadratic_prox_gd_batched(A, b, m, z, beta, inv_eta, steps, y0=y0)
    torch.cuda.synchronize()
    assert quadratic_prox_gd_batched.launches == 1 and prox_update_batched.launches == 0
    assert out.shape == z.shape and out.dtype == dtype
    want = quadratic_prox_gd_batched_plain(A, b, m, z, beta, inv_eta, steps, y0)
    torch.testing.assert_close(out, want, **K1_LOOP_TOL[dtype])
    start = z if y0 is None else y0
    assert (want - start).abs().max() > 1e-2  # the solve moved
    # one scalar pair for all rows
    out = quadratic_prox_gd_batched(A, b, m, z, 0.004, 2.0, steps, y0=y0)
    want = quadratic_prox_gd_batched_plain(A, b, m, z, 0.004, 2.0, steps, y0)
    torch.testing.assert_close(out, want, **K1_LOOP_TOL[dtype])


@pytest.mark.gpu
def test_quadratic_prox_loop_refuses_what_it_does_not_take(cuda):
    A = torch.eye(4, dtype=torch.float64, device=cuda).expand(3, 4, 4).contiguous()
    b = torch.zeros((3, 4), dtype=torch.float64, device=cuda)
    z = torch.zeros((2, 4), dtype=torch.float64, device=cuda)
    m = torch.tensor([0, 2], device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        quadratic_prox_gd_batched(A.half(), b.half(), m, z.half(), 0.1, 2.0, 3)
    with pytest.raises(TypeError, match="other operands"):
        quadratic_prox_gd_batched(A, b.float(), m, z, 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="A \\(M, d, d\\)"):
        quadratic_prox_gd_batched(A[:, :3].contiguous(), b, m, z, 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="z and y0"):
        quadratic_prox_gd_batched(A, b, m, z[:, :3].contiguous(), 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quadratic_prox_gd_batched(A, b, m, z.cpu(), 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="int64"):
        quadratic_prox_gd_batched(A, b, m.cpu(), z, 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="int64"):
        quadratic_prox_gd_batched(A, b, m.int(), z, 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="outside"):
        quadratic_prox_gd_batched(A, b, torch.tensor([0, 3], device=cuda), z, 0.1, 2.0, 3)
    with pytest.raises(ValueError, match="outside"):
        quadratic_prox_gd_batched(A, b, torch.tensor([-1, 0], device=cuda), z, 0.1, 2.0, 3)
    assert quadratic_prox_gd_batched.launches == 0


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


def _k2_clients(M, n, d, R, dtype, device, seed=2):
    """Z (M, n, d) * 0.2, labels y (M, n) in {-1, 1}, clients m (R,), z and
    y0 (R, d), per-row beta and inv_eta."""
    gen = torch.Generator().manual_seed(seed)
    Z = _randn(gen, (M, n, d), dtype, device) * 0.2
    y = (torch.randint(0, 2, (M, n), generator=gen) * 2 - 1).to(device, dtype)
    m = torch.randint(0, M, (R,), generator=gen).to(device)
    z, y0 = (_randn(gen, (R, d), dtype, device) for _ in range(2))
    beta = torch.linspace(0.02, 0.3, R, dtype=dtype, device=device)
    inv_eta = torch.linspace(0.5, 3.0, R, dtype=dtype, device=device)
    return Z, y, m, z, y0, beta, inv_eta


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["batched", "indexed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_logistic_prox_cluster_shapes(cuda, entry, dtype):
    """Both entries at R in {1, 16, 40} (clusters of 8 and 3 blocks a row),
    n in {1, 7, 2000} (fewer rows than blocks, ragged, the Figure-2 clients'
    2000 with a resident slice) and d in {1, 123, 300}, with a y0."""
    for R in (1, 16, 40):
        for n in (1, 7, 2000):
            for d in (1, 123, 300):
                Z, y, m, z, y0, beta, inv_eta = _k2_clients(6, n, d, R, dtype, cuda, seed=R + n + d)
                if entry == "batched":
                    A = Z[m] * y[m][..., None]
                    out = logistic_prox_gd_batched(A, z, beta, inv_eta, 0.1, 9, y0=y0)
                    want = logistic_prox_gd_batched_plain(A, z, beta, inv_eta, 0.1, 9, y0)
                else:
                    out = logistic_prox_gd_indexed(Z, y, m, z, beta, inv_eta, 0.1, 9, y0=y0)
                    want = logistic_prox_gd_indexed_plain(Z, y, m, z, beta, inv_eta, 0.1, 9, y0)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, want, **K2_TOL[dtype],
                                           msg=lambda e: f"R {R}, n {n}, d {d}: {e}")
    assert logistic_prox_gd_batched.launches == 27


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_logistic_prox_takes_the_old_kernels_largest_n(cuda, dtype):
    """The most rows the one-block-a-row kernel took at d = 123, (n + d +
    512) itemsize = 232,448 bytes, still runs (now on the cluster route)."""
    isz = torch.empty((), dtype=dtype).element_size()
    n = 232_448 // isz - 123 - 512
    Z, y, m, z, _, beta, inv_eta = _k2_clients(2, n, 123, 2, dtype, cuda)
    out = logistic_prox_gd_indexed(Z, y, m, z, beta, inv_eta, 0.1, 3)
    want = logistic_prox_gd_indexed_plain(Z, y, m, z, beta, inv_eta, 0.1, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **K2_TOL[dtype])


@pytest.mark.gpu
def test_logistic_prox_is_deterministic_and_checks_its_clients(cuda, monkeypatch):
    """Two launches give the same bits (the cluster sums in a fixed order, no
    atomics); a client index outside [0, M) raises; dropping one cluster
    rank's partial gradient (chip_smoke.py's planted fault) is caught."""
    Z, y, m, z, _, beta, inv_eta = _k2_clients(60, 2000, 123, 16, torch.float64, cuda)
    first = logistic_prox_gd_indexed(Z, y, m, z, beta, inv_eta, 0.1, 20)
    second = logistic_prox_gd_indexed(Z, y, m, z, beta, inv_eta, 0.1, 20)
    assert torch.equal(first, second)
    for wrong in (60, -1):
        bad = m.clone()
        bad[3] = wrong
        with pytest.raises(ValueError, match="outside"):
            logistic_prox_gd_indexed(Z, y, bad, z, beta, inv_eta, 0.1, 20)
    assert logistic_prox_gd_batched.launches == 2
    want = logistic_prox_gd_indexed_plain(Z, y, m, z, beta, inv_eta, 0.1, 20)
    torch.testing.assert_close(first, want, **K2_TOL[torch.float64])
    monkeypatch.setattr(k2_module, "_DROP_RANK", 3)
    wrong = logistic_prox_gd_indexed(Z, y, m, z, beta, inv_eta, 0.1, 20)
    assert not torch.allclose(wrong, want, **K2_TOL[torch.float64])


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    y = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        prox_update_batched(y.half(), y.half(), y.half(), 0.1, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        prox_update_batched(y.t(), y.t(), y.t(), 0.1, 2.0)
    with pytest.raises(ValueError, match="share one"):
        prox_update_batched(y, y[:2], y, 0.1, 2.0)
    # Rows wider than the cluster route's 512 take the one-block-a-row
    # kernel, which holds n + d + 512 values in shared memory.
    A = torch.zeros((1, 28000, 600), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        logistic_prox_gd_batched(A, torch.zeros((1, 600), dtype=torch.float64, device=cuda),
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
    # One loop launch per quadratic prox solve (30 rounds), none of the
    # per-step kernel; one K2 launch per logistic solve.
    assert quadratic_prox_gd_batched.launches == 30 and prox_update_batched.launches == 0
    assert logistic_prox_gd_batched.launches == 30


# The registry substrate (run_batch(fused=False)) and the sequential drivers
# on the card against the same runs on the CPU with the same draws: comm
# equal, dist_sq within rtol 1e-9 over ENGINE_ROUNDS rounds, where the
# trajectories are still far above the float64 floor (chip_smoke's CPU
# replay).  These paths launch none of the sweep kernels.
ENGINE_ROUNDS = 20
ENGINE_CASES = {
    "svrp": (dict(grid={"eta": [0.05, 0.1], "p": 0.2}, num_steps=ENGINE_ROUNDS),
             dict(eta=0.05, p=0.2, num_steps=ENGINE_ROUNDS)),
    "catalyzed_svrp": (dict(grid={"mu": 1.0, "gamma": 0.5, "eta": 0.05, "p": 0.2}, num_outer=2,
                            inner_steps=ENGINE_ROUNDS // 2),
                       dict(mu=1.0, delta=4.0, gamma=0.5, p=0.2, num_outer=2,
                            inner_steps=ENGINE_ROUNDS // 2)),
    "svrg": (dict(grid={"stepsize": [1 / 240, 1 / 480], "p": 0.2}, num_steps=ENGINE_ROUNDS),
             dict(stepsize=1 / 240, p=0.2, num_steps=ENGINE_ROUNDS)),
}


def _engine_problem(dev):
    from repro_torch.problems import make_synthetic_quadratic

    return make_synthetic_quadratic(10, 6, L=80.0, delta=4.0, seed=1, device=dev)


def _same_run(got, want):
    assert torch.equal(got.comm.cpu(), want.comm.cpu())
    assert got.comm.dtype == want.comm.dtype
    torch.testing.assert_close(got.dist_sq.cpu(), want.dist_sq.cpu(), rtol=1e-9, atol=0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(ENGINE_CASES))
def test_registry_path_on_the_card_matches_the_cpu(cuda, algo):
    """`run_batch(fused=False)` and `run_sequential` on the card against
    `run_batch(fused=False)` on the CPU, with the same native draws."""
    from repro_torch.experiments import run_batch, run_sequential

    kw = dict(ENGINE_CASES[algo][0], seeds=2)
    cpu = run_batch(algo, _engine_problem("cpu"), device="cpu", **kw)
    gpu = run_batch(algo, _engine_problem("cuda"), **kw)
    seq = run_sequential(algo, _engine_problem("cuda"), **kw)
    _same_run(gpu, cpu)
    _same_run(seq, cpu)
    assert quadratic_prox_gd_batched.launches == prox_update_batched.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(ENGINE_CASES))
def test_sequential_driver_on_the_card_matches_the_cpu(cuda, algo):
    """The per-trial ``run_*`` driver on the card against the CPU, one record."""
    import repro_torch.core as core

    kw = ENGINE_CASES[algo][1]
    name = {"svrp": "run_svrp", "catalyzed_svrp": "run_catalyzed_svrp", "svrg": "run_svrg"}[algo]
    runs = []
    for dev in ("cpu", "cuda"):
        prob = _engine_problem(dev)
        x_star = prob.minimizer()
        runs.append(getattr(core, name)(prob, torch.zeros_like(x_star), x_star, seed=3,
                                        device=dev, **kw))
    _same_run(runs[1], runs[0])
    torch.testing.assert_close(runs[1].x_final.cpu(), runs[0].x_final, rtol=1e-9, atol=1e-15)


FLASH_CASES = [
    # (B, Sq, Skv, H, KVH, Dh, causal, window, q_offset)
    (2, 256, 256, 8, 2, 128, True, None, 0),  # GQA, causal, whole tiles
    (1, 200, 200, 6, 3, 80, True, None, 0),  # ragged, qwen3's head dim
    (2, 96, 160, 4, 2, 64, False, None, 0),  # non-causal, Sq != Skv
    (2, 300, 300, 4, 1, 64, True, 100, 0),  # sliding window, ragged
    (1, 64, 320, 4, 2, 128, True, None, 256),  # a chunk of queries at an offset
    (1, 40, 40, 2, 2, 64, True, 8, 100),  # window shorter than the offset: rows with no key
    # bf16 takes the wgmma + TMA route at Dh 64 and 128 (128-row q tiles, 128-key tiles):
    (1, 1000, 1000, 8, 8, 128, True, None, 0),  # ragged Sq, B*H 8 < 132 CTAs a wave, group 1
    (4, 513, 513, 48, 16, 64, True, None, 0),  # ragged by one row, B*H 192 > 132, group 3
    (2, 200, 712, 32, 4, 128, True, None, 512),  # Skv > Sq at an offset, group 8
    (1, 1000, 1000, 8, 1, 64, False, None, 0),  # non-causal, ragged Skv tail, group 8
    (3, 513, 700, 24, 8, 128, True, 300, 187),  # window at an offset, group 3
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Skv, H, KVH, Dh, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(2)
    q = _randn(gen, (B, Sq, H, Dh), dtype, cuda)
    k, v = (_randn(gen, (B, Skv, KVH, Dh), dtype, cuda) for _ in range(2))
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, **kw), **K4_TOL[dtype])


def _decode_masks(S, device):
    idx = torch.arange(S, device=device)
    pos, window = S + S // 3, S // 2
    abs_pos = idx + S * torch.div(pos - idx, S, rounding_mode="floor")
    ring = (abs_pos >= 0) & (abs_pos <= pos) & (pos - abs_pos < window)
    return {"prefix0": idx <= 0, "prefix": idx <= S // 3, "full": idx < S, "ring": ring}


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 1000, 24, 8, 128), (3, 257, 32, 8, 80), (2, 130, 12, 2, 64)])
def test_decode_attention_kernel_matches_plain(cuda, shape, q_dtype, cache_dtype):
    """Llama's G = 3, qwen3's head dim 80 (G = 4), qwen2's G = 6; q and the
    cache of either dtype; prefix and ring-buffer masks."""
    B, S, H, KVH, Dh = shape
    gen = torch.Generator().manual_seed(3)
    q = _randn(gen, (B, 1, H, Dh), q_dtype, cuda)
    k, v = (_randn(gen, (B, S, KVH, Dh), cache_dtype, cuda) for _ in range(2))
    low = torch.bfloat16 if torch.bfloat16 in (q_dtype, cache_dtype) else torch.float32
    masks = _decode_masks(S, cuda)
    for name, valid in masks.items():
        out = decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == q_dtype
        want = decode_attention_plain(q, k, v, valid)
        torch.testing.assert_close(out, want, **K5_TOL[low], msg=name)
        if low == torch.bfloat16:
            diff, ref = (out.float() - want.float()), want.float()
            rel_l2 = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref)).item()
            max_abs, scale = diff.abs().max().item(), ref.abs().max().item()
            assert max_abs <= K5_BF16_SCALED * scale and rel_l2 <= K5_BF16_SCALED, (
                f"{name}: max abs {max_abs} (max |plain| {scale}), relative L2 {rel_l2}")
    assert decode_attention.launches == len(masks)


@pytest.mark.gpu
def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="other operands"):
        flash_attention(q, k.float(), k.float())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(), k[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="group"):
        flash_attention(torch.zeros((1, 8, 3, 64), dtype=torch.bfloat16, device=cuda), k, k)
    qd = torch.zeros((1, 1, 36, 64), dtype=torch.bfloat16, device=cuda)
    k4 = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=cuda)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 8"):
        decode_attention(qd, k4, k4, valid)
    with pytest.raises(ValueError, match="bool"):
        decode_attention(q[:, :1].contiguous(), k, k, valid.int())
    flat = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(q[:, :1].contiguous(), flat[1:].view(1, 8, 2, 64), k, valid)
    assert flash_attention.launches == 0 and decode_attention.launches == 0


@pytest.mark.gpu
def test_serving_path_goes_through_the_kernels(cuda):
    """A reduced llama (2 layers, head dim 64) in float32: prefill launches
    K4 once a layer, every decode token K5 once a layer, and the card's
    greedy tokens and prefill logits equal the CPU's (plain versions)."""
    import dataclasses

    from repro_torch.configs import REGISTRY
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(REGISTRY["llama3.2-3b"].reduced(), param_dtype="float32",
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    gpu = make_prefill_step(cfg)(on_card, {"tokens": tokens})
    assert flash_attention.launches == cfg.num_layers
    cpu = make_prefill_step(cfg, device="cpu")(params, {"tokens": tokens})
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-4, atol=1e-4)

    prompts = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10]]
    serve = ServeConfig(max_batch=2, cache_len=32)
    got = BatchServer(cfg, on_card, serve).generate(prompts, max_new_tokens=6)
    steps = (5 + 5) + (3 + 5)  # per group: prompt length + new tokens - 1
    assert decode_attention.launches == cfg.num_layers * steps
    assert got == BatchServer(cfg, params, serve, device="cpu").generate(prompts, max_new_tokens=6)


# ------------------------------------------------------------ K3 tree step
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_prox_update_tree_kernel_matches_plain(cuda, dtype):
    """One launch for a group of leaves: ragged sizes, a leaf of one element,
    a leaf larger than one chunk, and a leaf whose storage is not 16-byte
    aligned (the scalar path)."""
    gen = torch.Generator().manual_seed(4)
    shapes = [(3, 37), (129,), (1,), (70001,), (4, 5, 6)]
    ys, gs, zs = ([_randn(gen, s_, dtype, cuda) for s_ in shapes] for _ in range(3))
    flat = _randn(gen, (1 + 333,), dtype, cuda)
    ys.append(flat[1:])  # offset by one element
    gs.append(_randn(gen, (333,), dtype, cuda))
    zs.append(_randn(gen, (333,), dtype, cuda))
    out = prox_update(ys, gs, zs, 0.1, 2.0)
    torch.cuda.synchronize()
    assert prox_update.launches == 1
    for o, y, g, z in zip(out, ys, gs, zs):
        assert o.shape == y.shape and o.dtype == dtype
        torch.testing.assert_close(o, prox_update_plain(y, g, z, 0.1, 2.0), **K3_TOL[dtype])


@pytest.mark.gpu
def test_prox_update_tree_mixed_dtypes(cuda):
    """The reference's mixed tree (tests/test_kernels_prox.py:146-177): f32
    leaves, a bf16 leaf, f32 grads against bf16 params; one launch per dtype
    group."""
    gen = torch.Generator().manual_seed(5)
    y = {"a": _randn(gen, (3, 37), torch.float32, cuda), "b": _randn(gen, (129,), torch.float32, cuda),
         "c": _randn(gen, (4, 5), torch.bfloat16, cuda),
         "d": _randn(gen, (2, 2, 2), torch.float32, cuda)}
    g = {k: (v.float() * 0.3) for k, v in y.items()}
    z = {k: v - 0.25 for k, v in y.items()}
    got = ops.prox_update_tree(y, g, z, 0.1, 2.0)
    torch.cuda.synchronize()
    assert prox_update.launches == 2
    for k in y:
        assert got[k].dtype == y[k].dtype
        want = prox_update_plain(y[k], g[k], z[k], 0.1, 2.0)
        torch.testing.assert_close(got[k], want, **K3_TOL[y[k].dtype])


@pytest.mark.gpu
def test_prox_update_tree_refuses_what_it_does_not_take(cuda):
    y = torch.zeros(8, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="bfloat16, float32"):
        prox_update(y, y, y, 0.1, 2.0)
    y = torch.zeros((4, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        prox_update(y.t(), y.t(), y.t(), 0.1, 2.0)
    with pytest.raises(ValueError, match="leaf 0"):
        prox_update(y, y[:2], y, 0.1, 2.0)
    with pytest.raises(ValueError, match="at most"):
        prox_update([y] * 65, [y] * 65, [y] * 65, 0.1, 2.0)
    assert prox_update.launches == 0


# --------------------------------------------- K4's log-sum-exp and K4b
BWD_CASES = FLASH_CASES + [
    (2, 256, 256, 12, 2, 128, True, None, 0),  # qwen2's group of 6
    (1, 130, 130, 6, 1, 80, True, 50, 0),  # Dh 80, window, group 6
    # bf16 takes the wgmma + TMA route at Dh 64 and 128 and G <= 8 (a cluster of G blocks):
    (2, 300, 300, 12, 2, 64, True, 64, 0),  # group 6, Dh 64, window, ragged
    (1, 100, 356, 12, 2, 128, True, None, 256),  # group 6, q_offset, Sq != Skv
    (1, 40, 40, 6, 1, 128, True, 8, 100),  # group 6, rows with no key (dq exactly 0)
    (1, 130, 130, 12, 1, 64, True, None, 0),  # group 12 > 8: the mma.sync route
]


def _bwd_inputs(case, dtype, device, seed=6):
    B, Sq, Skv, H, KVH, Dh, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(seed)
    q = _randn(gen, (B, Sq, H, Dh), dtype, device)
    k, v = (_randn(gen, (B, Skv, KVH, Dh), dtype, device) for _ in range(2))
    do = _randn(gen, (B, Sq, H, Dh), dtype, device)
    return q, k, v, do, dict(causal=causal, sliding_window=window, q_offset=q_offset)


def _seen_rows(case, device):
    """(Sq,) bool: rows that see at least one key."""
    B, Sq, Skv, H, KVH, Dh, causal, window, q_offset = case
    return fa_module._mask(Sq, Skv, causal, window, q_offset, device).any(-1)


def _check_grads(got, want, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a).all()), name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, **K4B_F32_TOL, msg=name)
        else:
            diff, ref = a.float() - b.float(), b.float()
            max_abs, scale = diff.abs().max().item(), ref.abs().max().item()
            if scale == 0.0:  # every row sees no key: the gradient is exactly 0
                assert max_abs == 0.0, name
                continue
            rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref)).item()
            assert max_abs <= K4B_BF16_REL * scale and rel <= K4B_BF16_REL, (
                f"{name}: max abs {max_abs} (max |plain| {scale}), relative L2 {rel}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_lse_matches_plain(cuda, case, dtype):
    q, k, v, _, kw = _bwd_inputs(case, dtype, cuda)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    want_out, want_lse = flash_attention_plain(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    assert bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out, want_out, **K4_TOL[dtype])
    seen = _seen_rows(case, cuda)
    torch.testing.assert_close(lse[..., seen], want_lse[..., seen], rtol=0.0, atol=K4_LSE_ATOL)
    assert torch.equal(flash_attention(q, k, v, **kw), out)  # serving's call is unchanged


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_bwd_kernel_matches_plain(cuda, monkeypatch, case, dtype):
    """K4b against the plain backward on the same (q, k, v, out, lse, do);
    rows that see no key get dq = 0 without NaN.  The kernel that ran is the
    one `backward_route` names: only the wgmma route honours the planted
    dropped-rank fault."""
    q, k, v, do, kw = _bwd_inputs(case, dtype, cuda)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    _check_grads(got, want, dtype)
    unseen = ~_seen_rows(case, cuda)
    assert bool((got[0][:, unseen] == 0).all())
    route = fa_module.backward_route(dtype, q.shape[-1], q.shape[2] // k.shape[2])
    monkeypatch.setattr(fa_module, "_BWD_DROP_GROUP_RANK", 0)
    dk_rank0_dropped = flash_attention_bwd(q, k, v, out, lse, do, **kw)[1]
    if bool((want[1] != 0).any()):
        assert (not torch.equal(dk_rank0_dropped, got[1])) == (route == "wgmma_tma"), route


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_rejects_a_skipped_last_tile(cuda, monkeypatch, dh):
    """The planted fault chip_smoke.py uses: K4's wgmma route dropping the
    last key tile of every row block fails the bf16 check."""
    case = (2, 256, 256, 12, 4, dh, True, None, 0)
    q, k, v, _, kw = _bwd_inputs(case, torch.bfloat16, cuda)
    assert fa_module.forward_route(torch.bfloat16, dh) == "wgmma_tma"
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(flash_attention(q, k, v, **kw), want, **K4_TOL[torch.bfloat16])
    monkeypatch.setattr(fa_module, "_FWD_SKIP_LAST_KEY_TILES", 1)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(flash_attention(q, k, v, **kw), want,
                                   **K4_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 256, 256, 12, 2, 128, True, None, 0),
                                  (2, 300, 300, 12, 2, 64, True, 64, 0)],
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_bwd_rejects_a_dropped_group_rank(cuda, monkeypatch, case):
    """The wgmma route's planted fault: one query head of each group of 6
    left out of dK and dV fails the bf16 check (dq alone still passes)."""
    q, k, v, do, kw = _bwd_inputs(case, torch.bfloat16, cuda)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    _check_grads(flash_attention_bwd(q, k, v, out, lse, do, **kw), want, torch.bfloat16)
    monkeypatch.setattr(fa_module, "_BWD_DROP_GROUP_RANK", 3)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    _check_grads(got[:1] + want[1:], want, torch.bfloat16)
    with pytest.raises(AssertionError):
        _check_grads(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_flash_attention_bwd_wgmma_launches_agree(cuda):
    """Two launches of the wgmma route: dK and dV (summed over the group in
    rank order) bit for bit; dQ (bulk reduce-adds across key tiles, in no
    fixed order) within K4B_BF16_REL of each other in relative L2."""
    case = (2, 512, 512, 12, 2, 128, True, None, 0)
    q, k, v, do, kw = _bwd_inputs(case, torch.bfloat16, cuda)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    a = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    b = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    spread = (torch.linalg.vector_norm(a[0].float() - b[0].float())
              / torch.linalg.vector_norm(b[0].float())).item()
    assert spread <= K4B_BF16_REL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_flash_attention_bwd_without_queries(cuda, dtype, dh):
    """No query (Sq = 0) against 100 keys: dK and dV are exactly 0 on every
    route, though the wrapper allocates them uninitialised (the freed block
    they reuse is filled with NaN first)."""
    B, Skv, H, KVH = 2, 100, 12, 2
    gen = torch.Generator().manual_seed(9)
    q = _randn(gen, (B, 0, H, dh), dtype, cuda)
    k, v = (_randn(gen, (B, Skv, KVH, dh), dtype, cuda) for _ in range(2))
    lse = torch.empty((B, H, 0), dtype=torch.float32, device=cuda)
    del_me = torch.full((2, B, Skv, KVH, dh), float("nan"), dtype=dtype, device=cuda)
    del del_me
    dq, dk, dv = flash_attention_bwd(q, k, v, torch.empty_like(q), lse, torch.empty_like(q))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == 1
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert bool((dk == 0).all()) and bool((dv == 0).all())


@pytest.mark.gpu
def test_flash_attention_bwd_rejects_a_skipped_tile(cuda, monkeypatch):
    """The planted fault chip_smoke.py uses: K4b treating the first 64-key
    tile as masked fails the bf16 check."""
    case = (2, 256, 256, 12, 2, 128, True, None, 0)
    q, k, v, do, kw = _bwd_inputs(case, torch.bfloat16, cuda)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    monkeypatch.setattr(fa_module, "_BWD_SKIP_KEY_TILES", 1)
    with pytest.raises(AssertionError):
        _check_grads(flash_attention_bwd(q, k, v, out, lse, do, **kw), want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_gradient_goes_through_the_kernels(cuda, dtype):
    """`ops.attention` under autograd on the card: K4 forward and K4b
    backward once each, gradients as the plain versions give them."""
    case = (2, 96, 96, 12, 2, 64, True, None, 0)
    q, k, v, do, kw = _bwd_inputs(case, dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1 and flash_attention_bwd.launches == 1
    out_p, lse_p = flash_attention_plain(q, k, v, with_lse=True, **kw)
    _check_grads(got, flash_attention_bwd_plain(q, k, v, out_p, lse_p, do, **kw), dtype)


@pytest.mark.gpu
def test_attention_bwd_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((1, 4, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, k, q, lse.half(), q)
    with pytest.raises(ValueError, match="shaped like q"):
        flash_attention_bwd(q, k, k, q[:, :4].contiguous(), lse, q)
    with pytest.raises(TypeError, match="other operands"):
        flash_attention_bwd(q, k, k, q, lse, q.float())
    assert flash_attention_bwd.launches == 0


# ------------------------------------------------------------- K6 ssm_scan
def _ssm_inputs(shape, dtype, device, *, strong=False, with_state=False, seed=0):
    """x, B and C as column slices of one (B, T, C) tensor, as the model hands
    them; dt after softplus; A negative (A = -16 and dt in [0.5, 4] with
    ``strong``, as tests/test_torch_ssm_scan.py)."""
    gen = torch.Generator().manual_seed(seed)
    Bb, T, H, P, N = shape
    xbc = _randn(gen, (Bb, T, H * P + 2 * N), dtype, device)
    x = xbc[..., :H * P].view(Bb, T, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    if strong:
        dt = torch.rand((Bb, T, H), generator=gen).mul(3.5).add(0.5).to(device)
        A = torch.full((H,), -16.0, device=device)
    else:
        dt = torch.nn.functional.softplus(_randn(gen, (Bb, T, H), torch.float32, device) - 1.0)
        A = -torch.linspace(1.0, 16.0, H, device=device)
    D = _randn(gen, (H,), torch.float32, device)
    s0 = _randn(gen, (Bb, H, P, N), torch.float32, device) if with_state else None
    return x, dt, A, Bm, Cm, D, s0


SSM_CASES = [  # (B, T, H, P, N), strong decay, state0
    ((2, 300, 4, 64, 64), False, False),
    ((1, 1000, 3, 64, 64), False, True),
    ((2, 64, 2, 64, 64), True, True),
    ((1, 129, 3, 128, 16), False, True),
    ((2, 1, 2, 128, 16), False, False),
    ((2, 200, 80, 64, 64), False, True),  # Zamba2's heads on the tensor-core route
    ((1, 65, 1, 64, 64), True, False),  # one head, one step past a chunk
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SSM_CASES, ids=lambda c: "x".join(map(str, c[0])) +
                         ("_strong" if c[1] else "") + ("_state0" if c[2] else ""))
def test_ssm_scan_kernel_matches_plain(cuda, case, dtype):
    """T off the 64-step chunk, a given state0, strong decay (no NaN), the
    reduced config's P 128 / N 16; x, B and C read through their strides."""
    shape, strong, with_state = case
    x, dt, A, Bm, Cm, D, s0 = _ssm_inputs(shape, dtype, cuda, strong=strong,
                                          with_state=with_state)
    y, h = ssm_scan(x, dt, A, Bm, Cm, D, s0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == 1
    assert y.shape == x.shape and y.dtype == dtype and h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_p, h_p = ssm_scan_plain(x, dt, A, Bm, Cm, D, s0)
    torch.testing.assert_close(y, y_p, **K6_TOL[dtype])
    torch.testing.assert_close(h, h_p, **K6_STATE_TOL)
    if shape[1] <= 300:
        y_r, h_r = ssm_scan_ref(x, dt, A, Bm, Cm, D, s0)
        torch.testing.assert_close(y, y_r, **K6_TOL[dtype])
        torch.testing.assert_close(h, h_r, **K6_STATE_TOL)


def _ssm_strided(x, Bm, Cm):
    """x, B and C with an inner stride of 2 (not 16-byte runs): the
    tensor-core route stages them by plain loads instead of cp.async."""
    Bb, T, H, P = x.shape
    N = Bm.shape[-1]
    wide = torch.zeros((Bb, T, 2 * (H * P + 2 * N)), dtype=x.dtype, device=x.device)
    wide[..., 0::2] = torch.cat([x.reshape(Bb, T, H * P), Bm, Cm], dim=-1)
    return (wide[..., 0:2 * H * P:2].unflatten(-1, (H, P)),
            wide[..., 2 * H * P:2 * (H * P + N):2], wide[..., 2 * (H * P + N)::2])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "strided", "contiguous"])
@pytest.mark.parametrize("case", [((2, 300, 6, 64, 64), False, True),
                                  ((1, 200, 3, 64, 64), True, True),
                                  ((2, 1, 4, 64, 64), False, False)],
                         ids=lambda c: "x".join(map(str, c[0])) + ("_strong" if c[1] else ""))
def test_ssm_scan_tensor_core_route_matches_plain(cuda, case, layout):
    """The bf16 tensor-core route at the model's column views ("packed"), at
    an inner stride of 2 (staged by plain loads) and contiguous; within the
    bf16 tolerance of the plain version and of the recurrence, the state
    within 1e-3."""
    shape, strong, with_state = case
    x, dt, A, Bm, Cm, D, s0 = _ssm_inputs(shape, torch.bfloat16, cuda, strong=strong,
                                          with_state=with_state)
    if layout == "strided":
        x, Bm, Cm = _ssm_strided(x, Bm, Cm)
        assert x.stride(-1) == 2
    elif layout == "contiguous":
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    assert ssm_module.scan_route(x.dtype, shape[3], shape[4]) == "tensor_core"
    y, h = ssm_scan(x, dt, A, Bm, Cm, D, s0)
    torch.cuda.synchronize()
    y_p, h_p = ssm_scan_plain(x, dt, A, Bm, Cm, D, s0)
    torch.testing.assert_close(y, y_p, **K6_TOL[torch.bfloat16])
    torch.testing.assert_close(h, h_p, **K6_STATE_TOL)
    y_r, h_r = ssm_scan_ref(x, dt, A, Bm, Cm, D, s0)
    torch.testing.assert_close(y, y_r, **K6_TOL[torch.bfloat16])
    torch.testing.assert_close(h, h_r, **K6_STATE_TOL)


@pytest.mark.gpu
def test_ssm_scan_rejects_a_dropped_low_half(cuda, monkeypatch):
    """The tensor-core route's planted fault: the low bf16 parts of its
    split operands left out moves the state by ~2^-9 relative, beyond the
    1e-3 state tolerance (y, rounded to bf16, barely moves)."""
    x, dt, A, Bm, Cm, D, s0 = _ssm_inputs((2, 512, 8, 64, 64), torch.bfloat16, cuda,
                                          with_state=True)
    _, h_p = ssm_scan_plain(x, dt, A, Bm, Cm, D, s0)
    torch.testing.assert_close(ssm_scan(x, dt, A, Bm, Cm, D, s0)[1], h_p, **K6_STATE_TOL)
    monkeypatch.setattr(ssm_module, "_DROP_LOW_HALF", True)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(ssm_scan(x, dt, A, Bm, Cm, D, s0)[1], h_p, **K6_STATE_TOL)


@pytest.mark.gpu
def test_ssm_scan_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, D, _ = _ssm_inputs((1, 70, 2, 64, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="not built"):
        ssm_scan(x[..., :32], dt, A, Bm, Cm, D)
    with pytest.raises(TypeError, match="x's dtype"):
        ssm_scan(x, dt, A, Bm.float(), Cm, D)
    with pytest.raises(TypeError, match="float32"):
        ssm_scan(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ssm_scan(x.double(), dt, A, Bm.double(), Cm.double(), D)
    with pytest.raises(ValueError, match="state0"):
        ssm_scan(x, dt, A, Bm, Cm, D, torch.zeros((1, 2, 64, 63), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(x, dt, A, Bm, Cm, D, torch.zeros((1, 2, 64, 64), device=cuda).transpose(2, 3))
    with pytest.raises(ValueError, match="is on cpu"):
        ssm_scan(x, dt, A.cpu(), Bm, Cm, D)
    with pytest.raises(RuntimeError, match="ops.ssm_scan"):
        ssm_scan(x.float().requires_grad_(), dt, A, Bm.float(), Cm.float(), D)
    with pytest.raises(ValueError, match="dy"):
        ssm_scan_bwd(x, dt, A, Bm, Cm, D, None, torch.zeros_like(x, dtype=torch.float32))
    assert ssm_scan.launches == 0


@pytest.mark.gpu
def test_hybrid_serving_path_goes_through_the_kernels(cuda):
    """The reduced zamba2 with two groups (6 slots, 4 Mamba-2 layers, 2
    attention sites) in float32, LoRA b, conv_b and D randomised: prefill
    launches K6 once a Mamba-2 layer and K4 once a site, decode K5 once a site
    and K6 never; the card's prefill logits equal the CPU's (plain versions)
    within 1e-4, and so do its greedy tokens."""
    import dataclasses

    from repro_torch.configs import REGISTRY
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(REGISTRY["zamba2-2.7b"].reduced(), num_layers=6, attn_every=3,
                              param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    for site in params["loras"].values():
        site["b"].normal_(generator=gen).mul_(cfg.hybrid_lora_rank**-0.5)
    params["mamba_layers"]["conv_b"].normal_(generator=gen).mul_(0.1)
    params["mamba_layers"]["D"].normal_(generator=gen)
    on_card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    gpu = make_prefill_step(cfg)(on_card, {"tokens": tokens})
    assert ssm_scan.launches == 4 and flash_attention.launches == 2
    cpu = make_prefill_step(cfg, device="cpu")(params, {"tokens": tokens})
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-4, atol=1e-4)

    prompts = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10]]
    serve = ServeConfig(max_batch=2, cache_len=32)
    got = BatchServer(cfg, on_card, serve).generate(prompts, max_new_tokens=6)
    steps = (5 + 5) + (3 + 5)  # per group: prompt length + new tokens - 1
    assert decode_attention.launches == 2 * steps and ssm_scan.launches == 4
    assert got == BatchServer(cfg, params, serve, device="cpu").generate(prompts, max_new_tokens=6)


# ----------------------------------------------------------- K7 rwkv6_scan
RWKV_DECAYS = {"sigmoid": None, "strong": (0.03, 0.07), "weak": (0.998, 0.9999)}


def _rwkv_inputs(shape, dtype, device, *, decay="sigmoid", with_state=False, packed=False,
                 seed=0):
    """r, k, v, w (w = sigmoid(normal), or uniform in a strong- or weak-decay
    band, as tests/test_torch_rwkv6_scan.py), u, an optional state0; with
    ``packed`` r, k, v, w are column views of one (B, T, 4 H K) tensor, so
    the kernel reads them through strides that are not the contiguous ones."""
    gen = torch.Generator().manual_seed(seed)
    Bb, T, H, K = shape
    rkv = _randn(gen, (Bb, T, 3 * H * K), torch.float32, "cpu")
    band = RWKV_DECAYS[decay]
    w = (torch.sigmoid(_randn(gen, (Bb, T, H * K), torch.float32, "cpu")) if band is None
         else torch.rand((Bb, T, H * K), generator=gen) * (band[1] - band[0]) + band[0])
    packed_t = torch.cat([rkv, w], dim=-1).to(device, dtype)
    r, k, v, w = (packed_t[..., i * H * K:(i + 1) * H * K].reshape(Bb, T, H, K)
                  for i in range(4))
    if not packed:
        r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = _randn(gen, (H, K), torch.float32, device)
    s0 = _randn(gen, (Bb, H, K, K), torch.float32, device) if with_state else None
    return r, k, v, w, u, s0


RWKV_CASES = [  # (B, T, H, K), decay, state0, packed
    ((4, 2048, 32, 64), "sigmoid", False, False),  # rwkv6-1.6b's prefill
    ((8, 1, 32, 64), "sigmoid", True, False),  # its decode step
    ((2, 1000, 4, 64), "sigmoid", True, True),
    ((2, 300, 4, 64), "strong", True, False),
    ((2, 300, 4, 64), "weak", True, False),
    ((1, 33, 2, 8), "sigmoid", True, False),  # the reference's shapes
    ((2, 100, 3, 16), "sigmoid", False, True),
    ((1, 64, 4, 32), "sigmoid", True, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", RWKV_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"_{c[1]}" +
                         ("_state0" if c[2] else "") + ("_packed" if c[3] else ""))
def test_rwkv6_scan_kernel_matches_plain(cuda, case, dtype):
    """T off the 32-step tile, T = 1 with a state0 (decode), strong and weak
    decay, K 8 to 64, operands read through their strides."""
    shape, decay, with_state, packed = case
    r, k, v, w, u, s0 = _rwkv_inputs(shape, dtype, cuda, decay=decay, with_state=with_state,
                                     packed=packed)
    assert packed != r.is_contiguous()
    y, S = rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == 1
    assert y.shape == v.shape and y.dtype == dtype and S.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    y_p, S_p = rwkv6_scan_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(S, S_p, **K7_STATE_TOL)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y, y_p, **K7_TOL[dtype])
        return
    y_64, _ = rwkv6_scan_plain(r, k, v, w, u, s0, acc_dtype=torch.float64)
    for want in (y_p, y_64):
        rel = (torch.linalg.vector_norm(y - want) / torch.linalg.vector_norm(want)).item()
        assert rel <= K7_TOL[dtype]["rtol"], rel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 100])
def test_rwkv6_scan_state0_as_output_matches_plain(cuda, T, dtype):
    """K7 writing the final state over state0 (as decode runs it, at the
    decode shape and over 100 steps): the same y and state as the plain
    version from an untouched copy of state0."""
    r, k, v, w, u, s0 = _rwkv_inputs((8, T, 32, 64), dtype, cuda, with_state=True, seed=4)
    want_y, want_S = rwkv6_scan_plain(r, k, v, w, u, s0)
    state = s0.clone()
    y, S = rwkv6_scan(r, k, v, w, u, state, out_state=state)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == 1 and S.data_ptr() == state.data_ptr()
    torch.testing.assert_close(state, want_S, **K7_STATE_TOL)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y, want_y, **K7_TOL[dtype])
    else:
        rel = (torch.linalg.vector_norm(y - want_y) / torch.linalg.vector_norm(want_y)).item()
        assert rel <= K7_TOL[dtype]["rtol"], rel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K", [8, 16, 32, 64])
def test_rwkv6_scan_layouts(cuda, K, dtype):
    """At every K: T = 1 in place (decode) and T = 70 (off the 32-step
    tile) read through a K stride that is not 1 (the staging copies element
    by element), and a state0 / out_state that start off a 16-byte boundary
    (the state read and written element by element)."""
    r, k, v, w, u, s0 = _rwkv_inputs((3, 1, 5, K), dtype, cuda, with_state=True, seed=K)
    want_y, want_S = rwkv6_scan_plain(r, k, v, w, u, s0)
    state = s0.clone()
    y, S = rwkv6_scan(r, k, v, w, u, state, out_state=state)
    torch.cuda.synchronize()
    assert S.data_ptr() == state.data_ptr()
    torch.testing.assert_close(state, want_S, **K7_STATE_TOL)
    torch.testing.assert_close(y, want_y, **K7_TOL[dtype])
    r, k, v, w, u, s0 = _rwkv_inputs((2, 70, 3, K), dtype, cuda, with_state=True, seed=K + 1)
    r, k, v, w = (t.transpose(2, 3).contiguous().transpose(2, 3) for t in (r, k, v, w))
    assert r.stride(3) != 1
    off = torch.zeros(s0.numel() + 1, device=cuda)[1:].view(s0.shape)
    off.copy_(s0)
    want_y, want_S = rwkv6_scan_plain(r, k, v, w, u, s0)
    y, S = rwkv6_scan(r, k, v, w, u, off, out_state=off)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == 2
    torch.testing.assert_close(S, want_S, **K7_STATE_TOL)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y, want_y, **K7_TOL[dtype])
    else:
        rel = (torch.linalg.vector_norm(y - want_y) / torch.linalg.vector_norm(want_y)).item()
        assert rel <= K7_TOL[dtype]["rtol"], rel


@pytest.mark.gpu
def test_rwkv6_scan_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u, _ = _rwkv_inputs((1, 40, 2, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="not built"):
        rwkv6_scan(r[..., :48], k[..., :48], v[..., :48], w[..., :48], u[:, :48])
    with pytest.raises(TypeError, match="r's dtype"):
        rwkv6_scan(r, k, v, w.float(), u)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        rwkv6_scan(r.double(), k.double(), v.double(), w.double(), u)
    with pytest.raises(TypeError, match="float32"):
        rwkv6_scan(r, k, v, w, u.bfloat16())
    with pytest.raises(ValueError, match="state0"):
        rwkv6_scan(r, k, v, w, u, torch.zeros((1, 2, 64, 63), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(r, k, v, w, u, torch.zeros((1, 2, 64, 64), device=cuda).transpose(2, 3))
    with pytest.raises(ValueError, match="is on cpu"):
        rwkv6_scan(r, k, v, w, u.cpu())
    with pytest.raises(RuntimeError, match="ops.rwkv6_scan"):
        rwkv6_scan(r.float().requires_grad_(), k.float(), v.float(), w.float(), u)
    with pytest.raises(ValueError, match="out_state"):
        ops.rwkv6_scan(r.float().requires_grad_(), k.float(), v.float(), w.float(), u,
                       out_state=torch.zeros((1, 2, 64, 64), device=cuda))
    with pytest.raises(ValueError, match="dy"):
        rwkv6_scan_bwd(r, k, v, w, u, None, torch.zeros_like(r, dtype=torch.float32))
    with pytest.raises(ValueError, match="out_state"):
        rwkv6_scan(r, k, v, w, u, out_state=torch.zeros((1, 2, 64, 63), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        rwkv6_scan(r, k, v, w, u, out_state=torch.zeros((1, 2, 64, 64), device=cuda).double())
    two = torch.zeros((2, 1, 2, 64, 64), device=cuda).view(-1)
    with pytest.raises(ValueError, match="overlaps state0"):
        rwkv6_scan(r, k, v, w, u, two[:8192].view(1, 2, 64, 64),
                   out_state=two[4096:12288].view(1, 2, 64, 64))
    assert rwkv6_scan.launches == 0


@pytest.mark.gpu
def test_rwkv_serving_path_goes_through_the_kernels(cuda):
    """The reduced rwkv6 (2 layers, 4 heads of K 64) in float32, w0, w_b and
    u randomised: prefill launches K7 once a layer, decode once a layer a
    step; the card's prefill logits equal the CPU's (the plain scan) within
    1e-4, and so do its greedy tokens."""
    import dataclasses

    from repro_torch.configs import REGISTRY
    from repro_torch.launch import BatchServer, ServeConfig, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(REGISTRY["rwkv6-1.6b"].reduced(), param_dtype="float32",
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    tm = params["layers"]["tm"]
    tm["w0"].uniform_(-6.0, 1.0, generator=gen)
    tm["w_b"]["w"].normal_(generator=gen).mul_(64**-0.5)
    tm["u"].normal_(generator=gen)
    on_card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=torch.Generator().manual_seed(1))
    gpu = make_prefill_step(cfg)(on_card, {"tokens": tokens})
    assert rwkv6_scan.launches == cfg.num_layers
    cpu = make_prefill_step(cfg, device="cpu")(params, {"tokens": tokens})
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-4, atol=1e-4)

    prompts = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10]]
    serve = ServeConfig(max_batch=2, cache_len=32)
    rwkv6_scan.launches = 0
    got = BatchServer(cfg, on_card, serve).generate(prompts, max_new_tokens=6)
    steps = (5 + 5) + (3 + 5)  # per group: prompt length + new tokens - 1
    assert rwkv6_scan.launches == cfg.num_layers * steps
    assert got == BatchServer(cfg, params, serve, device="cpu").generate(prompts, max_new_tokens=6)


# ------------------------------------------------- DeepSVRP on the federated LM
@pytest.mark.gpu
def test_prox_update_batched_at_the_deep_svrp_width(cuda):
    """K1 as DeepSVRP's local step at the 20m preset: 8 rows (2 trials x 4
    clients) of 15,733,632 float32 values, bit for bit its plain version."""
    R, d = 8, 15_733_632
    gen = torch.Generator(device=cuda).manual_seed(0)
    y, g, z = (torch.randn(R, d, generator=gen, device=cuda) for _ in range(3))
    lr = torch.full((R,), 0.2, device=cuda)
    ie = torch.tensor([1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0], device=cuda)
    out = prox_update_batched(y, g, z, lr, ie)
    assert prox_update_batched.launches == 1
    assert torch.equal(out, prox_update_batched_plain(y, g, z, lr, ie))


def _fed_lm(dev):
    """A small federated LM at Dh 64 (the head dim the card's K4 builds)."""
    import dataclasses

    from repro_torch.configs import REGISTRY
    from repro_torch.problems import make_fed_lm_problem

    cfg = dataclasses.replace(REGISTRY["llama3.2-3b"].reduced(), num_layers=2, d_model=128,
                              num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
                              vocab_size=256, param_dtype="float32", compute_dtype="float32")
    return make_fed_lm_problem(cfg, num_clients=3, per_client_batch=2, seq_len=64, seed=0,
                               device=dev)


@pytest.mark.gpu
def test_fed_lm_gradient_on_the_card_matches_the_cpu(cuda):
    """One client gradient through K4 (forward with lse) and K4b, once a
    layer each, and the metric through K4 alone, against the CPU's plain
    attention at the float32 gradient tolerances."""
    prob, x0 = _fed_lm(cuda)
    cpu, x0_cpu = _fed_lm("cpu")
    x = x0.cpu()  # the card's weights on both sides
    g = prob.grad(torch.tensor(1, device=cuda), x.to(cuda))
    assert flash_attention.launches == flash_attention_bwd.launches == prob.cfg.num_layers
    torch.testing.assert_close(g.cpu(), cpu.grad(torch.tensor(1), x), rtol=1e-4, atol=1e-5)
    flash_attention.launches = 0
    loss = prob.metric(x.to(cuda))
    assert flash_attention.launches == prob.num_clients * prob.cfg.num_layers
    assert flash_attention_bwd.launches == prob.cfg.num_layers
    torch.testing.assert_close(loss.cpu(), cpu.metric(x), rtol=1e-5, atol=0.0)


@pytest.mark.gpu
def test_deep_svrp_on_the_card_matches_the_cpu(cuda):
    """run_batch("deep_svrp") on the small federated LM, fused and registry:
    K1 once a local step, the loss trajectory within the float32 round
    tolerance of the CPU run with the same coins, comm equal."""
    from repro_torch.core import draw_schedule
    from repro_torch.experiments import run_batch

    prob, x0 = _fed_lm(cuda)
    cpu, _ = _fed_lm("cpu")
    draws = draw_schedule([0, 1], 3, 3, 0.5, clients=False)
    kw = dict(grid={"eta": 1.0, "local_lr": 0.2, "anchor_prob": 0.5}, seeds=2, num_steps=3,
              local_steps=2, x0=x0, x_star=x0)
    want = run_batch("deep_svrp", cpu, draws=draws, device="cpu",
                     **{**kw, "x0": x0.cpu(), "x_star": x0.cpu()})
    for fused in (True, False):
        prox_update_batched.launches = 0
        got = run_batch("deep_svrp", prob, fused=fused, draws=draws, **kw)
        assert prox_update_batched.launches == 3 * 2
        assert torch.equal(got.comm.cpu(), want.comm)
        torch.testing.assert_close(got.dist_sq.cpu(), want.dist_sq, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_dp_logistic_fused_sweep_on_the_card_matches_the_cpu(cuda):
    """svrp on a DP logistic problem through K2 with the noise fold (the
    shifted target and y0 = z), once a round, against the CPU."""
    from repro_torch.core import draw_schedule
    from repro_torch.experiments import run_batch
    from repro_torch.problems import make_dp_a9a_problem

    runs = []
    for dev in ("cpu", "cuda"):
        prob = make_dp_a9a_problem(6, n_per_client=40, n_pool=300, dim=12, nnz_per_row=4,
                                   sigma=2.0, device=dev)
        x_star = prob.minimizer()
        kw = dict(grid={"eta": [0.5, 1.0], "p": 0.3, "smoothness": float(prob.smoothness_max())},
                  seeds=2, num_steps=20, prox_solver="gd", prox_steps=15, fused=True,
                  draws=draw_schedule([0, 0, 1, 1], 6, 20, 0.3), x_star=x_star)
        runs.append(run_batch("svrp", prob, device=dev, **kw))
    assert logistic_prox_gd_batched.launches == 20
    _same_run(runs[1], runs[0])


@pytest.mark.gpu
def test_deep_svrp_session_on_the_card_matches_run_batch(cuda):
    """A deep_svrp session on the small federated LM, stepped 1 + 2 rounds,
    equals run_batch (registry) over the same coins bit for bit, with K1
    once a local step in both."""
    from repro_torch.core import draw_schedule
    from repro_torch.experiments import run_batch
    from repro_torch.serve import open_session

    prob, x0 = _fed_lm(cuda)
    draws = draw_schedule([0, 1], 3, 3, 0.5, clients=False)
    kw = dict(grid={"eta": 1.0, "local_lr": 0.2, "anchor_prob": 0.5}, seeds=2, num_steps=3,
              local_steps=2, x0=x0, x_star=x0, draws=draws)
    want = run_batch("deep_svrp", prob, **kw)
    assert prox_update_batched.launches == 3 * 2
    sess = open_session("deep_svrp", prob, **kw)
    sess.step(1)
    sess.step(2)
    assert prox_update_batched.launches == 2 * 3 * 2
    assert torch.equal(sess.dist_sq, want.dist_sq) and torch.equal(sess.comm, want.comm)
    assert torch.equal(sess.x(), want.x_final)


@pytest.mark.gpu
def test_pool_on_the_card_matches_standalone_sessions(cuda):
    """Two svrp tenants on distinct quadratics, stacked into one lane batch,
    against their own sessions on the card (rtol 1e-5, comm exact)."""
    from repro_torch.problems import make_synthetic_quadratic
    from repro_torch.serve import SessionPool, open_session

    probs = [make_synthetic_quadratic(20, 8, mu=1.0, L=300.0, delta=3.0, seed=s, device=cuda)
             for s in (1, 2)]
    kws = [dict(grid={"eta": e, "p": 0.1}, seeds=3, num_steps=30) for e in (0.05, 0.03)]
    pool = SessionPool(capacity=3)
    ids = [pool.admit("svrp", p, **kw) for p, kw in zip(probs, kws)]
    assert pool.stacked
    pool.step(10)
    pool.step(20)
    for tid, p, kw in zip(ids, probs, kws):
        ref = open_session("svrp", p, **kw)
        ref.step(30)
        got = pool.result(tid)
        assert torch.equal(got.comm, ref.comm)
        torch.testing.assert_close(got.dist_sq, ref.dist_sq, rtol=1e-5, atol=1e-24)


@pytest.mark.gpu
def test_server_on_the_card_matches_the_cpu(cuda):
    """The streaming server's draws are made on the host, so the card's
    rounds and the CPU's take the same clients and coins: comm equal,
    dist_sq within rtol 1e-9 over 20 rounds of churn."""
    from repro_torch.problems import make_synthetic_quadratic
    from repro_torch.serve import ClientStream, FedRoundServer

    runs = []
    for dev in ("cpu", cuda):
        prob = make_synthetic_quadratic(30, 8, mu=1.0, L=300.0, delta=3.0, seed=4, device=dev)
        srv = FedRoundServer("svrp_minibatch", prob, hparams={"eta": 0.05, "p": 0.1},
                             batch_clients=4, stream=ClientStream(30, churn=0.2, seed=1), seed=2,
                             device=dev)
        runs.append(srv.run(20))
    assert runs[0].comm == runs[1].comm
    torch.testing.assert_close(torch.tensor(runs[1].dist_sq), torch.tensor(runs[0].dist_sq),
                               rtol=1e-9, atol=0.0)


# ------------------------------------------------ scan backwards (K6b, K7b)
def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    den = torch.linalg.vector_norm(want).item()
    num = torch.linalg.vector_norm(got - want).item()
    return num / den if den > 0 else num


def _assert_grads_close(got, want, tol, names):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, a.dtype, b.dtype)
        assert bool(torch.isfinite(a).all()), name
        rel = _rel_l2(a, b)
        assert rel <= tol, (name, rel)


SSM_GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dstate0")
SSM_BWD_CASES = [  # (B, T, H, P, N), strong decay, state0 (and a final-state cotangent)
    ((2, 300, 4, 64, 64), False, True),
    ((1, 65, 3, 64, 64), True, False),
    ((1, 129, 3, 128, 16), False, True),
    ((2, 1, 2, 128, 16), False, True),
    ((2, 1024, 80, 64, 64), False, False),  # Zamba2's training shape
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SSM_BWD_CASES, ids=lambda c: "x".join(map(str, c[0])) +
                         ("_strong" if c[1] else "") + ("_state0" if c[2] else ""))
def test_ssm_scan_bwd_kernel_matches_plain(cuda, case, dtype):
    """K6b against the plain backward: T off the 64-step chunk, strong decay
    (no NaN), state0 with a cotangent on the final state, x, B and C read
    through their strides; two launches give the same bits."""
    shape, strong, with_state = case
    x, dt, A, Bm, Cm, D, s0 = _ssm_inputs(shape, dtype, cuda, strong=strong,
                                          with_state=with_state, seed=3)
    gen = torch.Generator().manual_seed(5)
    dy = _randn(gen, x.shape, dtype, cuda)
    dh = _randn(gen, (shape[0], shape[2], shape[3], shape[4]), torch.float32, cuda) \
        if with_state else None
    got = ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh)
    again = ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == 2
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    want = ssm_scan_bwd_plain(x, dt, A, Bm, Cm, D, s0, dy, dh)
    _assert_grads_close(got, want, K6B_REL[dtype], SSM_GRAD_NAMES)


@pytest.mark.gpu
def test_ssm_scan_bwd_rejects_a_dropped_carry(cuda, monkeypatch):
    """The planted fault (the state's cotangent not carried from a chunk to
    the one before) leaves the tolerance."""
    x, dt, A, Bm, Cm, D, s0 = _ssm_inputs((1, 300, 4, 64, 64), torch.float32, cuda,
                                          with_state=True, seed=3)
    dy = torch.randn(x.shape, device=cuda)
    want = ssm_scan_bwd_plain(x, dt, A, Bm, Cm, D, s0, dy)
    monkeypatch.setattr(ssm_module, "_BWD_DROP_CARRY", True)
    got = ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy)
    assert _rel_l2(got[0], want[0]) > K6B_REL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_gradient_goes_through_the_kernels(cuda, dtype):
    """`ops.ssm_scan` under autograd: K6 and K6b once each, the gradients
    those of `ssm_scan_bwd` bit for bit; y's and the state's cotangents both
    reach it."""
    x, dt, A, Bm, Cm, D, s0 = _ssm_inputs((2, 200, 4, 64, 64), dtype, cuda, with_state=True,
                                          seed=4)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D, s0)]
    y, h = ops.ssm_scan(*leaves)
    gen = torch.Generator().manual_seed(6)
    dy, dh = _randn(gen, y.shape, dtype, cuda), _randn(gen, h.shape, torch.float32, cuda)
    grads = torch.autograd.grad([y, h], leaves, [dy, dh])
    torch.cuda.synchronize()
    assert ssm_scan.launches == 1 and ssm_scan_bwd.launches == 1
    want = ssm_scan_bwd(x, dt, A, Bm, Cm, D, s0, dy, dh)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


RWKV_GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
RWKV_BWD_CASES = [  # (B, T, H, K), decay, state0 (and a final-state cotangent), packed
    ((2, 1024, 32, 64), "sigmoid", False, False),  # rwkv6-1.6b's training shape
    ((2, 300, 4, 64), "strong", True, False),
    ((2, 300, 4, 64), "weak", True, True),
    ((1, 33, 2, 8), "sigmoid", True, False),  # the reference's shapes
    ((2, 100, 3, 16), "sigmoid", False, True),
    ((1, 64, 4, 32), "sigmoid", True, False),
    ((2, 1, 3, 64), "sigmoid", True, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", RWKV_BWD_CASES, ids=lambda c: "x".join(map(str, c[0])) +
                         f"_{c[1]}" + ("_state0" if c[2] else "") + ("_packed" if c[3] else ""))
def test_rwkv6_scan_bwd_kernel_matches_plain(cuda, case, dtype):
    """K7b against the plain backward: T off the 32-step tile, strong and weak
    decay, K 8 to 64, state0 with a final-state cotangent, operands read
    through their strides; two launches give the same bits."""
    shape, decay, with_state, packed = case
    r, k, v, w, u, s0 = _rwkv_inputs(shape, dtype, cuda, decay=decay, with_state=with_state,
                                     packed=packed, seed=7)
    gen = torch.Generator().manual_seed(8)
    dy = _randn(gen, r.shape, dtype, cuda)
    Bb, _, H, K = shape
    dS = _randn(gen, (Bb, H, K, K), torch.float32, cuda) if with_state else None
    got = rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS)
    again = rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS)
    torch.cuda.synchronize()
    assert rwkv6_scan_bwd.launches == 2
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    want = rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, dS)
    _assert_grads_close(got, want, K7B_REL[dtype], RWKV_GRAD_NAMES)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["dw_from_next_state", "skip_recompute"])
def test_rwkv6_scan_bwd_rejects_planted_faults(cuda, monkeypatch, fault):
    """dw reading S_t for S_{t-1}, and one tile's states not recomputed
    (read from the tile after it), each leave the tolerance on dw."""
    r, k, v, w, u, s0 = _rwkv_inputs((2, 300, 4, 64), torch.float32, cuda, with_state=True,
                                     seed=9)
    dy = torch.randn(r.shape, device=cuda)
    want = rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy)
    if fault == "dw_from_next_state":
        monkeypatch.setattr(rwkv_module, "_BWD_DW_FROM_NEXT_STATE", True)
    else:
        monkeypatch.setattr(rwkv_module, "_BWD_SKIP_RECOMPUTE_TILE", 4)
    got = rwkv6_scan_bwd(r, k, v, w, u, s0, dy)
    assert _rel_l2(got[3], want[3]) > K7B_REL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv_gradient_goes_through_the_kernels(cuda, dtype):
    """`ops.rwkv6_scan` under autograd: K7 and K7b once each, the gradients
    those of `rwkv6_scan_bwd` bit for bit."""
    r, k, v, w, u, s0 = _rwkv_inputs((2, 100, 4, 64), dtype, cuda, with_state=True, seed=10)
    leaves = [t.detach().clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, S = ops.rwkv6_scan(*leaves)
    gen = torch.Generator().manual_seed(11)
    dy, dS = _randn(gen, y.shape, dtype, cuda), _randn(gen, S.shape, torch.float32, cuda)
    grads = torch.autograd.grad([y, S], leaves, [dy, dS])
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == 1 and rwkv6_scan_bwd.launches == 1
    want = rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dS)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
