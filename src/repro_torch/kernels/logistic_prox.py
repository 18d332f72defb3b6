"""The whole Algorithm-7 loop on the ``(R, n, d)`` logistic oracle, one launch.

Port of the TPU kernel `repro.kernels.logistic_prox.logistic_prox_gd_batched`
(src/repro/kernels/logistic_prox.py:64) as a CUDA C++ kernel for Hopper
(`csrc/logistic_prox.cu`: one block per row, the step loop inside the
kernel).  With label-signed rows A = y[:, None] * Z, each GD step is

    t = A x;  g = -A' sigmoid(-t)/n + lam x;  x <- x - beta (g + (x - z)/eta)

started from ``y0`` (default ``z``).  `logistic_prox_gd_batched` launches
the kernel for CUDA tensors and counts each launch in
``logistic_prox_gd_batched.launches``; for CPU tensors it runs the plain
PyTorch version `logistic_prox_gd_batched_plain` (and counts nothing).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_ARGTYPES = {
    f"logistic_prox_gd_batched_{s}": [_P, _P, _P, _P, _P, ctypes.c_double, _I, _I, _I, _I, _I, _P, _P]
    for s in _build.SUFFIX.values()
}
_THREADS = 512  # csrc/logistic_prox.cu kThreads
_MAX_SMEM = 232_448  # bytes of shared memory one Hopper block may use


def logistic_prox_gd_batched_plain(A, z, beta, inv_eta, lam, num_steps, y0=None):
    """The plain version (the reference's `ref.logistic_prox_gd_batched`)."""
    R, n, _ = A.shape
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device).broadcast_to((R,))
    inv_eta = torch.as_tensor(inv_eta, dtype=z.dtype, device=z.device).broadcast_to((R,))
    x = z if y0 is None else y0
    for _ in range(num_steps):
        t = torch.einsum("bnd,bd->bn", A, x)
        u = 0.5 * (torch.tanh(-0.5 * t) + 1.0)  # sigmoid(-t)
        g = -torch.einsum("bn,bnd->bd", u, A) / n + lam * x
        x = x - beta[:, None] * (g + (x - z) * inv_eta[:, None])
    return x


def logistic_prox_gd_batched(A, z, beta, inv_eta, lam: float, num_steps: int, *, y0=None):
    """`num_steps` of Algorithm 7 for every row of ``A`` (R, n, d); returns the
    ``(R, d)`` approximate prox points.  ``beta``/``inv_eta`` are ``(R,)`` or
    scalars; ``lam`` is the shared l2 coefficient."""
    if A.device.type == "cpu":
        return logistic_prox_gd_batched_plain(A, z, beta, inv_eta, lam, num_steps, y0)
    name = "logistic_prox_gd_batched"
    x0 = z if y0 is None else y0
    dtype = _build.check_cuda_operands(name, A=A, z=z, y0=x0)
    if A.ndim != 3 or z.shape != (A.shape[0], A.shape[2]) or x0.shape != z.shape:
        raise ValueError(f"{name}: expected A (R, n, d) with z, y0 (R, d), got "
                         f"{tuple(A.shape)}, {tuple(z.shape)}, {tuple(x0.shape)}")
    R, n, d = A.shape
    if n < 1 or num_steps < 0:
        raise ValueError(f"{name}: needs n >= 1 rows and num_steps >= 0")
    smem = (d + n + _THREADS) * A.element_size()
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: n + d = {n + d} needs {smem} bytes of shared memory, "
                         f"more than a block's {_MAX_SMEM}")
    beta_t, ie_t, stride = _build.row_scalars(name, ("beta", "inv_eta"), (beta, inv_eta), R, z)
    out = torch.empty_like(z)
    fn = getattr(_build.load("logistic_prox", _ARGTYPES), f"{name}_{_build.SUFFIX[dtype]}")
    status = fn(A.data_ptr(), z.data_ptr(), x0.data_ptr(), beta_t.data_ptr(), ie_t.data_ptr(),
                float(lam), R, n, d, int(num_steps), stride, out.data_ptr(), _build.stream_of(A))
    _build.check_status(name, status)
    logistic_prox_gd_batched.launches += 1
    return out


logistic_prox_gd_batched.launches = 0
