"""The whole Algorithm-7 loop on the logistic oracle, one launch: K2.

Port of the TPU kernel `repro.kernels.logistic_prox.logistic_prox_gd_batched`
(src/repro/kernels/logistic_prox.py:64) as a CUDA C++ kernel for Hopper
(`csrc/logistic_prox.cu`).  With label-signed rows A = y[:, None] * Z, each
GD step is

    t = A x;  g = -A' sigmoid(-t)/n + lam x;  x <- x - beta (g + (x - z)/eta)

started from ``y0`` (default ``z``).  Two entries launch the same kernel:

* `logistic_prox_gd_batched(A, z, ...)`, the reference's signature: row r
  reads the signed rows ``A[r]``;
* `logistic_prox_gd_indexed(Z, y, m, z, ...)`, the sweep's: row r reads
  client ``m[r]``'s features ``Z[m[r]]`` in place and folds its labels
  ``y[m[r]]`` in as it reads them, so nothing is gathered or multiplied on
  the device before the launch.  Its plain version gathers and multiplies
  as the sweep did before, then runs the plain loop.

Routes, by ``d`` alone: up to ``D_MAX`` = 512 columns a row is split over a
thread-block cluster of C blocks (the largest C <= 8 whose R clusters the
card holds in one wave; see the source), each keeping as many of its rows
in shared memory as fit and reading the rest from L2, with the partial
gradients reduced through distributed shared memory; wider rows take the
old one-block-a-row kernel, which takes ``(n + d + 512) itemsize <=
232,448`` bytes as before.  Both count each launch in
``logistic_prox_gd_batched.launches``; for CPU tensors they run the plain
PyTorch versions (and count nothing).  A CUDA tensor the kernel does not
take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_i = ctypes.c_int
_ARGTYPES = {
    **{f"logistic_prox_gd_{s}": [_P] * 7 + [ctypes.c_double] + [_I] * 5 + [_P, _i, _i, _i, _P]
       for s in _build.SUFFIX.values()},
    "logistic_prox_max_clusters": [_i, _I, _i, _i, ctypes.POINTER(_i)],
}
_THREADS = 512  # csrc/logistic_prox.cu kThreads
_WARPS = _THREADS // 32
_MAX_SMEM = 232_448  # bytes of shared memory one Hopper block may use
D_MAX = 32 * 16  # the cluster route's widest row: 16 values a lane
MAX_CLUSTER = 8  # the portable cluster size

# chip_smoke.py's measurements of the design's options and its planted fault
# (each left as it is in every real run): a fixed cluster size (None: chosen
# from R), rows kept in shared memory (False: every step reads A from L2),
# and one cluster rank whose partial gradient the sum leaves out (-1: none).
_CLUSTER = None
_RESIDENT = True
_DROP_RANK = -1


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


def logistic_prox_gd_indexed_plain(Z, y, m, z, beta, inv_eta, lam, num_steps, y0=None):
    """The indexed entry's plain version: the label-signed rows of the
    sampled clients, ``Z[m] * y[m][:, :, None]``, then the plain loop."""
    A = Z[m] * y[m][:, :, None]
    return logistic_prox_gd_batched_plain(A, z, beta, inv_eta, lam, num_steps, y0)


def cluster_size(rows: int, n: int, d: int, dtype, device) -> int:
    """Blocks a row: the most, up to the portable 8, whose ``rows`` clusters
    the card holds in one wave (asked of the card once a shape; an H100
    holds 15 clusters of 8 full blocks and fewer than 16 of 7, so R 16 takes
    6); 1 when even single blocks take waves."""
    if _CLUSTER is not None:
        return _CLUSTER
    isz = torch.empty((), dtype=dtype).element_size()
    for c in range(MAX_CLUSTER, 0, -1):
        if _clusters_at_once(device, dtype, d, c, resident_rows(n, d, c, isz)) >= rows:
            return c
    return 1


_OCCUPANCY: dict = {}  # (device, dtype, d, cluster, resident rows) -> clusters at once


def _clusters_at_once(device, dtype, d, cluster, res_rows):
    key = (device.index, dtype, d, cluster, res_rows)
    if key not in _OCCUPANCY:
        _OCCUPANCY[key] = clusters_at_once(dtype, d, cluster, res_rows)
    return _OCCUPANCY[key]


def resident_rows(n: int, d: int, cluster: int, itemsize: int) -> int:
    """Rows a block of the cluster route keeps in shared memory: all of its
    share of n where they fit beside x, the two step partials and the warp
    partials, else as many as fit."""
    if not _RESIDENT:
        return 0
    fit = (_MAX_SMEM // itemsize - (3 + _WARPS) * d) // d
    return max(0, min(-(-n // cluster), fit))


def clusters_at_once(dtype, d: int, cluster: int, res_rows: int) -> int:
    """How many of the cluster route's clusters (``cluster`` blocks, each
    keeping ``res_rows`` rows of width ``d``) the card holds at once; more
    rows than that run in waves."""
    count = _i(0)
    status = _build.load("logistic_prox", _ARGTYPES).logistic_prox_max_clusters(
        int(dtype == torch.float64), d, cluster, res_rows, ctypes.byref(count))
    _build.check_status("logistic_prox_max_clusters", status)
    return count.value


def _launch(name, A, y, m, z, x0, beta, inv_eta, lam, num_steps):
    """One launch of K2 (``y`` and ``m`` None: ``A`` is signed, row r reads A[r])."""
    R, d = z.shape
    n = A.shape[1]
    if num_steps < 0:
        raise ValueError(f"{name}: num_steps must be >= 0, got {num_steps}")
    if n < 1:
        raise ValueError(f"{name}: needs n >= 1 rows")
    isz = A.element_size()
    cluster, res = 1, 0
    if d <= D_MAX:
        cluster = cluster_size(R, n, d, A.dtype, A.device)
        res = resident_rows(n, d, cluster, isz)
    elif (d + n + _THREADS) * isz > _MAX_SMEM:
        raise ValueError(f"{name}: n + d = {n + d} needs {(d + n + _THREADS) * isz} bytes of "
                         f"shared memory, more than a block's {_MAX_SMEM} (rows wider than "
                         f"{D_MAX} take the one-block-a-row kernel)")
    beta_t, ie_t, stride = _build.row_scalars(name, ("beta", "inv_eta"), (beta, inv_eta), R, z)
    out = torch.empty_like(z)
    fn = getattr(_build.load("logistic_prox", _ARGTYPES),
                 f"logistic_prox_gd_{_build.SUFFIX[z.dtype]}")
    status = fn(A.data_ptr(), None if y is None else y.data_ptr(),
                None if m is None else m.data_ptr(), z.data_ptr(), x0.data_ptr(),
                beta_t.data_ptr(), ie_t.data_ptr(), float(lam), R, n, d, int(num_steps), stride,
                out.data_ptr(), cluster, res, _DROP_RANK, _build.stream_of(z))
    _build.check_status(name, status)
    logistic_prox_gd_batched.launches += 1
    return out


def logistic_prox_gd_batched(A, z, beta, inv_eta, lam: float, num_steps: int, *, y0=None):
    """`num_steps` of Algorithm 7 for every row of ``A`` (R, n, d); returns the
    ``(R, d)`` approximate prox points.  ``beta``/``inv_eta`` are ``(R,)`` or
    scalars; ``lam`` is the shared l2 coefficient."""
    if A.device.type == "cpu":
        return logistic_prox_gd_batched_plain(A, z, beta, inv_eta, lam, num_steps, y0)
    name = "logistic_prox_gd_batched"
    x0 = z if y0 is None else y0
    _build.check_cuda_operands(name, A=A, z=z, y0=x0)
    if A.ndim != 3 or z.shape != (A.shape[0], A.shape[2]) or x0.shape != z.shape:
        raise ValueError(f"{name}: expected A (R, n, d) with z, y0 (R, d), got "
                         f"{tuple(A.shape)}, {tuple(z.shape)}, {tuple(x0.shape)}")
    return _launch(name, A, None, None, z, x0, beta, inv_eta, lam, num_steps)


def logistic_prox_gd_indexed(Z, y, m, z, beta, inv_eta, lam: float, num_steps: int, *,
                             y0=None, check_indices: bool = True):
    """`logistic_prox_gd_batched` on the rows ``y[m[r]] * Z[m[r]]``, read in
    place: ``Z`` (M, n, d) features, ``y`` (M, n) labels (+-1), ``m`` the
    ``(R,)`` int64 client of each row, ``z`` and ``y0`` (R, d).  The kernel
    reads ``Z[m]`` unchecked, so the wrapper refuses indices outside
    ``[0, M)``, which waits on the device once; a caller whose indices were
    checked already (a sweep checks its draws when it starts) passes
    ``check_indices=False``."""
    if Z.device.type == "cpu":
        return logistic_prox_gd_indexed_plain(Z, y, m, z, beta, inv_eta, lam, num_steps, y0)
    name = "logistic_prox_gd_indexed"
    x0 = z if y0 is None else y0
    _build.check_cuda_operands(name, Z=Z, y=y, z=z, y0=x0)
    if Z.ndim != 3 or y.shape != Z.shape[:2]:
        raise ValueError(f"{name}: expected Z (M, n, d) and y (M, n), got {tuple(Z.shape)}, "
                         f"{tuple(y.shape)}")
    M, d = Z.shape[0], Z.shape[2]
    if z.ndim != 2 or z.shape[1] != d or x0.shape != z.shape:
        raise ValueError(f"{name}: expected z and y0 ({z.shape[0] if z.ndim else '?'}, {d}), "
                         f"got {tuple(z.shape)}, {tuple(x0.shape)}")
    R = z.shape[0]
    if m.device != Z.device or m.dtype != torch.int64 or m.shape != (R,) or not m.is_contiguous():
        raise ValueError(f"{name}: m must be a contiguous int64 ({R},) tensor on {Z.device}, got "
                         f"{m.dtype} {tuple(m.shape)} on {m.device}")
    if R and M == 0:
        raise ValueError(f"{name}: {R} rows but no client")
    if R and check_indices:
        lo, hi = (int(v) for v in torch.aminmax(m))
        if lo < 0 or hi >= M:
            raise ValueError(f"{name}: client indices span [{lo}, {hi}], outside [0, {M})")
    return _launch(name, Z, y, m, z, x0, beta, inv_eta, lam, num_steps)


logistic_prox_gd_batched.launches = 0
