"""The Algorithm-7 step  y <- y - lr (g + (y - z) inv_eta)  on the card: K1 and K3.

All are CUDA C++ kernels for Hopper in `csrc/prox_update.cu`, built by
`kernels._build`.

* `prox_update_batched` (K1) ports the TPU kernel
  `repro.kernels.prox_update.prox_update_batched`
  (src/repro/kernels/prox_update.py:91): the batched step of a sweep, rows
  are the trials (or trial x cohort pairs) and each row has its own
  ``(lr, inv_eta)``.  Catalyst's shifted solves take it, one launch per GD
  step.
* `quadratic_prox_gd_batched` (K1's loop form) runs ``num_steps`` of that
  step with the quadratic gradient ``A[m] y - b[m]`` fused in, the whole
  solve in one launch; the quadratic sweeps (sppm, svrp, svrp_minibatch)
  take it.  Its plain version takes each step as the gradient of
  `QuadraticProblem.local_oracle`, then K1's plain update.
* `prox_update` (K3) ports `repro.kernels.prox_update.prox_update`
  (src/repro/kernels/prox_update.py:45): one step, one pair of scalars, over
  one tensor of any shape or over a whole group of leaves of one dtype in
  one launch (the DeepSVRP local step, `kernels.ops.prox_update_tree`).
  ``g`` is rounded to ``y``'s dtype first, and so are ``lr`` and
  ``inv_eta``, as the reference rounds them (`jnp.asarray(local_lr, dtype)`).

Each wrapper launches its kernel for CUDA tensors and counts each launch in
its ``.launches`` attribute; for CPU tensors it runs its plain PyTorch
version (`prox_update_batched_plain`, `prox_update_plain`) and counts
nothing.  A CUDA tensor the kernel does not take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_ARGTYPES = {
    **{f"prox_update_batched_{s}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
       for s in _build.SUFFIX.values()},
    **{f"prox_update_tree_{s}": [ctypes.POINTER(_I), ctypes.c_int, ctypes.c_double,
                                 ctypes.c_double, _P]
       for s in ("bf16", "f32", "f64")},
    **{f"quadratic_prox_gd_batched_{s}": [_P] * 8 + [_I] * 4 + [_P]
       for s in _build.SUFFIX.values()},
}
TREE_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}
MAX_LEAVES = 64  # leaves of one launch: the kernel's parameter block (csrc/prox_update.cu)


def prox_update_batched_plain(y, g, z, local_lr, inv_eta):
    """The plain version (the reference's `ref.prox_update_batched`): y, g, z
    are ``(R, *trail)``; local_lr and inv_eta are ``(R,)`` or scalars."""
    R = y.shape[0]
    extra = (1,) * (y.ndim - 1)
    lr = torch.as_tensor(local_lr, dtype=y.dtype, device=y.device).broadcast_to((R,)).reshape(R, *extra)
    ie = torch.as_tensor(inv_eta, dtype=y.dtype, device=y.device).broadcast_to((R,)).reshape(R, *extra)
    return y - lr * (g + (y - z) * ie)


def prox_update_batched(y, g, z, local_lr, inv_eta):
    """Per-row fused update for a ``(R, *trail)`` batch, one kernel launch."""
    if y.device.type == "cpu":
        return prox_update_batched_plain(y, g, z, local_lr, inv_eta)
    name = "prox_update_batched"
    dtype = _build.check_cuda_operands(name, y=y, g=g, z=z)
    if g.shape != y.shape or z.shape != y.shape or y.ndim < 1:
        raise ValueError(f"{name}: y, g, z must share one (R, ...) shape, got "
                         f"{tuple(y.shape)}, {tuple(g.shape)}, {tuple(z.shape)}")
    R = y.shape[0]
    d = math.prod(y.shape[1:])
    lr, ie, stride = _build.row_scalars(name, ("local_lr", "inv_eta"), (local_lr, inv_eta), R, y)
    out = torch.empty_like(y)
    fn = getattr(_build.load("prox_update", _ARGTYPES), f"{name}_{_build.SUFFIX[dtype]}")
    status = fn(y.data_ptr(), g.data_ptr(), z.data_ptr(), lr.data_ptr(), ie.data_ptr(),
                out.data_ptr(), R, d, stride, _build.stream_of(y))
    _build.check_status(name, status)
    prox_update_batched.launches += 1
    return out


prox_update_batched.launches = 0

# Planted fault for chip_smoke.py's checks: the loop kernel runs this many
# steps fewer than asked (0 in every real run).
_LOOP_SKIP_STEPS = 0


def quadratic_prox_gd_batched_plain(A, b, m, z, beta, inv_eta, num_steps, y0=None):
    """The plain version: ``num_steps`` times `QuadraticProblem.local_oracle`'s
    gradient ``A[m] y - b[m]``, then `prox_update_batched_plain`."""
    A_m, b_m = A[m], b[m]
    y = z if y0 is None else y0
    for _ in range(num_steps):
        g = torch.matmul(A_m, y.unsqueeze(-1)).squeeze(-1) - b_m
        y = prox_update_batched_plain(y, g, z, beta, inv_eta)
    return y


def quadratic_prox_gd_batched(A, b, m, z, beta, inv_eta, num_steps: int, y0=None, *,
                              check_indices: bool = True):
    """``num_steps`` Algorithm-7 steps on the quadratics ``(A[m[r]], b[m[r]])``,
    every row at once, from ``y0`` (default ``z``): one kernel launch.

    ``A`` is ``(M, d, d)``, ``b`` ``(M, d)``, ``m`` the ``(R,)`` int64 client of
    each row, ``z`` and ``y0`` ``(R, d)``; ``beta`` and ``inv_eta`` are ``(R,)``
    or scalars, taken as `prox_update_batched` takes its ``(lr, inv_eta)``.
    The kernel reads ``A[m]`` unchecked, so the wrapper refuses indices
    outside ``[0, M)``, which waits on the device once; a caller whose
    indices were checked already (a sweep checks its draws when it starts)
    passes ``check_indices=False``."""
    if A.device.type == "cpu":
        return quadratic_prox_gd_batched_plain(A, b, m, z, beta, inv_eta, num_steps, y0)
    name = "quadratic_prox_gd_batched"
    x0 = z if y0 is None else y0
    dtype = _build.check_cuda_operands(name, A=A, b=b, z=z, y0=x0)
    if A.ndim != 3 or A.shape[1] != A.shape[2] or b.shape != A.shape[:2]:
        raise ValueError(f"{name}: expected A (M, d, d) and b (M, d), got {tuple(A.shape)}, "
                         f"{tuple(b.shape)}")
    M, d = A.shape[0], A.shape[2]
    if z.ndim != 2 or z.shape[1] != d or x0.shape != z.shape:
        raise ValueError(f"{name}: expected z and y0 ({z.shape[0] if z.ndim else '?'}, {d}), "
                         f"got {tuple(z.shape)}, {tuple(x0.shape)}")
    R = z.shape[0]
    if m.device != A.device or m.dtype != torch.int64 or m.shape != (R,) or not m.is_contiguous():
        raise ValueError(f"{name}: m must be a contiguous int64 ({R},) tensor on {A.device}, got "
                         f"{m.dtype} {tuple(m.shape)} on {m.device}")
    if num_steps < 0:
        raise ValueError(f"{name}: num_steps must be >= 0, got {num_steps}")
    if R and M == 0:
        raise ValueError(f"{name}: {R} rows but no client")
    if R and check_indices:
        lo, hi = (int(v) for v in torch.aminmax(m))
        if lo < 0 or hi >= M:
            raise ValueError(f"{name}: client indices span [{lo}, {hi}], outside [0, {M})")
    beta_t, ie_t, stride = _build.row_scalars(name, ("beta", "inv_eta"), (beta, inv_eta), R, z)
    out = torch.empty_like(z)
    fn = getattr(_build.load("prox_update", _ARGTYPES), f"{name}_{_build.SUFFIX[dtype]}")
    status = fn(A.data_ptr(), b.data_ptr(), m.data_ptr(), z.data_ptr(), x0.data_ptr(),
                beta_t.data_ptr(), ie_t.data_ptr(), out.data_ptr(), R, d,
                max(int(num_steps) - _LOOP_SKIP_STEPS, 0), stride, _build.stream_of(z))
    _build.check_status(name, status)
    quadratic_prox_gd_batched.launches += 1
    return out


quadratic_prox_gd_batched.launches = 0


def prox_update_plain(y, g, z, local_lr, inv_eta):
    """The plain version (the reference's `ref.prox_update` as
    `ops.prox_update_tree` calls it): ``g``, ``lr`` and ``inv_eta`` rounded
    to ``y``'s dtype, every operation in that dtype."""
    lr = torch.as_tensor(local_lr, dtype=y.dtype, device=y.device)
    ie = torch.as_tensor(inv_eta, dtype=y.dtype, device=y.device)
    return y - lr * (g.to(y.dtype) + (y - z) * ie)


def prox_update(y, g, z, local_lr, inv_eta):
    """One Algorithm-7 step over ``y`` (a tensor, or a list of leaves of one
    dtype) with ``g`` and ``z`` alike: one kernel launch for all of it.
    Returns a new tensor, or a list, like ``y``."""
    if isinstance(y, torch.Tensor):
        return prox_update([y], [g], [z], local_lr, inv_eta)[0]
    ys, gs, zs = list(y), list(g), list(z)
    if not (len(ys) == len(gs) == len(zs)):
        raise ValueError(f"prox_update: {len(ys)} y leaves, {len(gs)} g, {len(zs)} z")
    if not ys or ys[0].device.type == "cpu":
        return [prox_update_plain(a, b, c, local_lr, inv_eta) for a, b, c in zip(ys, gs, zs)]
    name = "prox_update"
    dtype = ys[0].dtype
    if dtype not in TREE_DTYPES:
        raise TypeError(f"{name}: y has dtype {dtype}; the kernel takes bfloat16, float32 "
                        "or float64")
    if len(ys) > MAX_LEAVES:
        raise ValueError(f"{name}: {len(ys)} leaves in one launch; the kernel takes at most "
                         f"{MAX_LEAVES}")
    table, outs = [], []
    for i, (a, b, c) in enumerate(zip(ys, gs, zs)):
        b = b.to(dtype)  # the reference's g.astype(y.dtype)
        _build.check_cuda_operands(f"{name} (leaf {i})", dtypes=(dtype,), y=a, g=b, z=c)
        if b.shape != a.shape or c.shape != a.shape:
            raise ValueError(f"{name}: leaf {i} has y {tuple(a.shape)}, g {tuple(b.shape)}, "
                             f"z {tuple(c.shape)}")
        if a.device != ys[0].device:
            raise ValueError(f"{name}: leaf {i} is on {a.device}, leaf 0 on {ys[0].device}")
        out = torch.empty_like(a)
        outs.append(out)
        table += [a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), a.numel()]
    scalars = [torch.as_tensor(v, dtype=dtype).item() for v in (local_lr, inv_eta)]
    fn = getattr(_build.load("prox_update", _ARGTYPES), f"prox_update_tree_{TREE_DTYPES[dtype]}")
    status = fn((ctypes.c_longlong * len(table))(*table), len(ys), *scalars,
                _build.stream_of(ys[0]))
    _build.check_status(name, status)
    prox_update.launches += 1
    return outs


prox_update.launches = 0
