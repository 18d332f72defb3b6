"""Batched Algorithm-7 step  y <- y - lr_r (g + (y - z) inv_eta_r)  per row r.

Port of the TPU kernel `repro.kernels.prox_update.prox_update_batched`
(src/repro/kernels/prox_update.py:91) as a CUDA C++ kernel for Hopper
(`csrc/prox_update.cu`, built by `kernels._build`).  Rows are the trials of a
sweep (or trial x cohort pairs); each row has its own ``(lr, inv_eta)``.

`prox_update_batched` launches the kernel for CUDA tensors and counts each
launch in ``prox_update_batched.launches``; for CPU tensors it runs the plain
PyTorch version `prox_update_batched_plain` (and counts nothing).  A CUDA
tensor the kernel does not take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_ARGTYPES = {
    f"prox_update_batched_{s}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    for s in _build.SUFFIX.values()
}


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
