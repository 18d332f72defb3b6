"""Mamba-2 selective state-space scan (scalar decay per head): K6.

* `ssm_scan` (K6) ports the TPU kernel `repro.kernels.ssm_scan.ssm_scan`
  (src/repro/kernels/ssm_scan.py:68) as CUDA C++ kernels for Hopper
  (`csrc/ssm_scan.cu`, built by `kernels._build`), each walking 64-step
  chunks in order.  The route depends on dtype and (P, N) alone
  (`scan_route`): bf16 at P = N = 64 (Zamba2's) runs on tensor cores, a
  block per (head, batch row), three to an SM, every float32 operand of a
  product split into bf16 high and low parts; float32 and P 128 / N 16 run
  the float32 FMA kernel, a block per (head, batch row).
  It is the scan of every Mamba-2 layer's full-sequence forward (`models.ssm.mamba_apply`), and so of every prefill of the hybrid
  family; decode runs its own one-step recurrence (`mamba_decode_step`).
* `ssm_scan_plain` is its plain version, the port of the reference's
  chunked jnp form `ssm_scan_chunked` (src/repro/kernels/_ssm_chunked.py:18),
  which is what `repro.kernels.ops.ssm_scan` runs off the TPU.
* `ssm_scan_split_plain` models the tensor-core route's arithmetic in
  plain PyTorch (64-step chunks, the split operands), for the tests.
* `ssm_scan_ref` is the sequential recurrence of the reference's oracle
  `ref.ssm_scan` (src/repro/kernels/ref.py:89), for the tests.

The contract is the reference's: x ``(B, T, H, P)``; dt ``(B, T, H)``
float32 (positive, after softplus); A and D ``(H,)`` float32 (A negative);
B_mat and C_mat ``(B, T, N)``, one group shared by all heads; an optional
state0 ``(B, H, P, N)`` float32.  Per step, with state h ``(B, H, P, N)``,

    h   = exp(A dt_t) h + dt_t x_t (x) B_t
    y_t = h C_t + D x_t

Returns ``(y, state)``: y ``(B, T, H, P)`` in x's dtype, the final state in
float32.

`ssm_scan` launches K6 for CUDA tensors and counts each launch in
``ssm_scan.launches``; for CPU tensors it runs `ssm_scan_plain` (and counts
nothing).  A CUDA tensor the kernel does not take raises; nothing falls
back.  K6 has no backward: under autograd a CUDA input that needs a
gradient raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

PLAIN_CHUNK = 128  # the reference's chunk (`ssm_scan_chunked`); K6 chunks at 64 steps
K6_CHUNK = 64  # csrc/ssm_scan.cu kQ
SHAPES = ((64, 64), (128, 16))  # (P, N) built: Zamba2's and its reduced variant's
TENSOR_CORE_SHAPE = (64, 64)
_P = ctypes.c_void_p
_i = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {"ssm_scan_fwd": [_P] * 9 + [_i] * 6 + [_L] * 13 + [_i, _P]}

# Planted fault for chip_smoke.py's checks: the tensor-core route leaves out
# the low bf16 parts of its split operands (False in every real run).
_DROP_LOW_HALF = False


def scan_route(dtype: torch.dtype, P: int, N: int) -> str:
    """Which K6 kernel a CUDA call runs (`ssm_scan_fwd` in csrc/ssm_scan.cu
    chooses by the same rule): "tensor_core" for bf16 at (P, N) = (64, 64),
    "fma_f32" otherwise."""
    return "tensor_core" if dtype == torch.bfloat16 and (P, N) == TENSOR_CORE_SHAPE else "fma_f32"


def ssm_scan_plain(x, dt, A, B_mat, C_mat, D, state0=None):
    """The plain version: the reference's `ssm_scan_chunked`, chunk by
    chunk in float32 (intra-chunk products masked before the exponent)."""
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    f32 = torch.float32
    Q = min(PLAIN_CHUNK, T)
    pad = (-T) % Q
    xf, dtf, Bm, Cm = x.to(f32), dt.to(f32), B_mat.to(f32), C_mat.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    A_, D_ = A.to(f32), D.to(f32)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if state0 is None
         else state0.to(f32))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, T + pad, Q):
        xq, dtq = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]  # (B,Q,H,P), (B,Q,H)
        Bq, Cq = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]  # (B,Q,N)
        cum = torch.cumsum(A_ * dtq, dim=1)  # inclusive
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, H)
        # zero the masked exponents BEFORE exp: for s > t they are positive
        # and exp can overflow to inf (0 * inf = NaN)
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        BC = torch.einsum("bsn,btn->bts", Bq, Cq)
        W = L * BC[..., None] * dtq[:, None, :, :]  # (B, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", W, xq)
        y = y + torch.einsum("btn,bhpn->bthp", Cq, h) * torch.exp(cum)[..., None]
        ys.append(y + D_[None, None, :, None] * xq)
        tot = cum[:, -1:, :]  # (B, 1, H)
        w_out = torch.exp(tot - cum) * dtq  # (B, Q, H)
        h = (torch.exp(tot[:, 0])[:, :, None, None] * h
             + torch.einsum("bshp,bsn->bhpn", w_out[..., None] * xq, Bq))
    return torch.cat(ys, dim=1)[:, :T].to(x.dtype), h


def _split(v, drop_low=False):
    """v as bf16 high part + bf16 low part (float32 values): what the
    tensor-core route feeds its products for a float32 operand."""
    hi = v.to(torch.bfloat16).float()
    return hi if drop_low else hi + (v - hi).to(torch.bfloat16).float()


def ssm_scan_split_plain(x, dt, A, B_mat, C_mat, D, state0=None, *, drop_low=False):
    """The tensor-core route's arithmetic in plain PyTorch: 64-step chunks;
    C B^T from the operands as given; G = L o (C B^T) o dt, the state h and
    ws o x each replaced by its bf16 high + low split before the product
    that takes it (with ``drop_low``, by the high part alone: the route's
    planted fault); every product and sum in float32."""
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    f32 = torch.float32
    Q = K6_CHUNK
    pad = (-T) % Q
    xf, dtf, Bm, Cm = x.to(f32), dt.to(f32), B_mat.to(f32), C_mat.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    A_, D_ = A.to(f32), D.to(f32)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if state0 is None
         else state0.to(f32))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, T + pad, Q):
        xq, dtq = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        Bq, Cq = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        cum = torch.cumsum(A_ * dtq, dim=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        CB = torch.einsum("btn,bsn->bts", Cq, Bq)
        G = _split(CB[..., None] * L * dtq[:, None, :, :], drop_low)  # (B, t, s, H)
        y = torch.einsum("bhpn,btn->bthp", _split(h, drop_low), Cq) * torch.exp(cum)[..., None]
        y = y + torch.einsum("btsh,bshp->bthp", G, xq)
        ys.append(y + D_[None, None, :, None] * xq)
        tot = cum[:, -1:, :]
        wx = _split((torch.exp(tot - cum) * dtq)[..., None] * xq, drop_low)  # (B, s, H, P)
        h = torch.exp(tot[:, 0])[:, :, None, None] * h + torch.einsum("bshp,bsn->bhpn", wx, Bq)
    return torch.cat(ys, dim=1)[:, :T].to(x.dtype), h


def ssm_scan_ref(x, dt, A, B_mat, C_mat, D, state0=None):
    """The sequential recurrence (the reference's oracle `ref.ssm_scan`),
    one step at a time in float32."""
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    f32 = torch.float32
    xf, dtf, Bm, Cm = x.to(f32), dt.to(f32), B_mat.to(f32), C_mat.to(f32)
    A_, D_ = A.to(f32), D.to(f32)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) if state0 is None
         else state0.to(f32))
    ys = []
    for t in range(T):
        decay = torch.exp(A_[None] * dtf[:, t])  # (B, H)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * Bm[:, t][:, None, None, :]
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]) + D_[None, :, None] * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), h


def _check(name, x, dt, A, B_mat, C_mat, D, state0):
    """Raise unless the operands are what K6 takes; returns (B, T, H, P, N)."""
    tensors = dict(x=x, dt=dt, A=A, B_mat=B_mat, C_mat=C_mat, D=D)
    if state0 is not None:
        tensors["state0"] = state0
    for arg, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
    if x.ndim != 4 or dt.ndim != 3 or B_mat.ndim != 3 or C_mat.shape != B_mat.shape:
        raise ValueError(f"{name}: expected x (B, T, H, P), dt (B, T, H), B_mat and C_mat "
                         f"(B, T, N), got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B_mat.shape)}, {tuple(C_mat.shape)}")
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    if dt.shape != (Bb, T, H) or B_mat.shape[:2] != (Bb, T):
        raise ValueError(f"{name}: dt {tuple(dt.shape)} and B_mat {tuple(B_mat.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"{name}: (P, N) = ({P}, {N}) not built; the kernel takes {SHAPES}")
    if x.dtype not in _build.ATTENTION_DTYPES:
        raise TypeError(f"{name}: x has dtype {x.dtype}; the kernel takes bfloat16 or float32")
    if B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError(f"{name}: B_mat {B_mat.dtype} and C_mat {C_mat.dtype} must have x's "
                        f"dtype {x.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"{name}: dt has dtype {dt.dtype}; the kernel takes float32")
    _build.check_cuda_operands(name, dtypes=(torch.float32,), A=A, D=D)
    if A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"{name}: A {tuple(A.shape)} and D {tuple(D.shape)} must be ({H},)")
    if state0 is not None:
        _build.check_cuda_operands(name, dtypes=(torch.float32,), state0=state0)
        if state0.shape != (Bb, H, P, N):
            raise ValueError(f"{name}: state0 {tuple(state0.shape)} must be ({Bb}, {H}, {P}, {N})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(f"{name}: K6 has no backward yet; the hybrid family's "
                                  f"training is not ported")
    return Bb, T, H, P, N


def ssm_scan(x, dt, A, B_mat, C_mat, D, state0=None):
    """The scan of one Mamba-2 layer (see the module docstring), one launch."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B_mat, C_mat, D, state0)
    name = "ssm_scan"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, expected a CUDA tensor")
    Bb, T, H, P, N = _check(name, x, dt, A, B_mat, C_mat, D, state0)
    y = torch.empty((Bb, T, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    fn = _build.load("ssm_scan", _ARGTYPES).ssm_scan_fwd
    status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
                D.data_ptr(), None if state0 is None else state0.data_ptr(), y.data_ptr(),
                h_out.data_ptr(), int(x.dtype == torch.bfloat16), Bb, T, H, P, N,
                *x.stride(), *dt.stride(), *B_mat.stride(), *C_mat.stride(),
                int(_DROP_LOW_HALF), _build.stream_of(x))
    _build.check_status(name, status)
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0
