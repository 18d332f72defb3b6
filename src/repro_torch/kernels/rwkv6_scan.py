"""RWKV-6 WKV recurrence (per-channel data-dependent decay and bonus): K7.

* `rwkv6_scan` (K7) ports the TPU kernel `repro.kernels.rwkv6_scan.rwkv6_scan`
  (src/repro/kernels/rwkv6_scan.py:58) as a CUDA C++ kernel for Hopper
  (`csrc/rwkv6_scan.cu`: a block per (head, batch row, 16 columns of the
  state), eight lanes per column holding its rows in registers, 32-step
  tiles of r, k, w and v staged in shared memory, float32 FMA; built by
  `kernels._build`).  It is the scan of every time-mix layer
  (`models.rwkv.timemix_apply`) on both serving paths: over the whole
  sequence at prefill and with T = 1 and the carried state at decode.
* `rwkv6_scan_plain` is its plain version, the port of the reference's
  oracle `ref.rwkv6_scan` (src/repro/kernels/ref.py:58), which is what
  `repro.kernels.ops.rwkv6_scan` runs off the TPU: a loop over time in
  float32, y rounded once to r's dtype.

The contract is the reference's: r, k and w ``(B, T, H, K)`` and v
``(B, T, H, V)`` of one dtype, w the decay factor in (0, 1); u ``(H, K)``
float32; an optional state0 ``(B, H, K, V)`` float32.  Per step, with state
S ``(B, H, K, V)``,

    y_t = (S + u (x) (k_t v_t^T))^T r_t
    S   = diag(w_t) S + k_t v_t^T

Returns ``(y, state)``: y ``(B, T, H, V)`` in r's dtype, the final state in
float32.  The final state is written into ``out_state`` when one is given
(a contiguous float32 ``(B, H, K, V)`` tensor, which may be state0 itself:
decode steps each layer's state in place) and returned as it.

`rwkv6_scan` launches K7 for CUDA tensors and counts each launch in
``rwkv6_scan.launches``; for CPU tensors it runs `rwkv6_scan_plain` (and
counts nothing).  A CUDA tensor the kernel does not take raises; nothing
falls back.  K7 has no backward: under autograd a CUDA input that needs a
gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SHAPES = (8, 16, 32, 64)  # K = V built: rwkv6's head size 64 and the reference's test sizes
_P = ctypes.c_void_p
_i = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {"rwkv6_scan_fwd": [_P] * 8 + [_i] * 5 + [_L] * 16 + [_P]}


def rwkv6_scan_plain(r, k, v, w, u, state0=None, *, out_state=None, acc_dtype=torch.float32):
    """The plain version: the reference's oracle, one step at a time in
    float32 (the read with the bonus, then decay and write).  With
    ``acc_dtype=torch.float64`` it is the yardstick of K7's float32
    accuracy; the state is returned in ``acc_dtype`` (or copied into
    ``out_state``)."""
    Bb, T, H, K = r.shape
    V = v.shape[-1]
    acc = acc_dtype
    r_, k_, v_, w_ = (a.to(acc) for a in (r, k, v, w))
    u_ = u.to(acc)[None, :, :, None]
    S = (torch.zeros((Bb, H, K, V), dtype=acc, device=r.device) if state0 is None
         else state0.to(acc))
    ys = []
    for t in range(T):
        kv = k_[:, t, :, :, None] * v_[:, t, :, None, :]  # (B, H, K, V)
        ys.append(torch.einsum("bhkv,bhk->bhv", S + u_ * kv, r_[:, t]))
        S = w_[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros((Bb, 0, H, V), dtype=acc, device=r.device)
    if out_state is not None:
        S = out_state.copy_(S)
    return y.to(r.dtype), S


def _check(name, r, k, v, w, u, state0, out_state=None):
    """Raise unless the operands are what K7 takes; returns (B, T, H, K)."""
    tensors = dict(r=r, k=k, v=v, w=w, u=u)
    for arg, t in (("state0", state0), ("out_state", out_state)):
        if t is not None:
            tensors[arg] = t
    for arg, t in tensors.items():
        if t.device != r.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, r on {r.device}")
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"{name}: expected r, k, w (B, T, H, K) and v (B, T, H, V), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(w.shape)}, "
                         f"{tuple(v.shape)}")
    Bb, T, H, K = r.shape
    if v.shape[-1] != K or K not in SHAPES:
        raise ValueError(f"{name}: K = {K}, V = {v.shape[-1]} not built; the kernel takes "
                         f"K = V in {SHAPES}")
    if r.dtype not in _build.ATTENTION_DTYPES:
        raise TypeError(f"{name}: r has dtype {r.dtype}; the kernel takes bfloat16 or float32")
    for arg, t in (("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}; it must have r's dtype "
                            f"{r.dtype}")
    _build.check_cuda_operands(name, dtypes=(torch.float32,), u=u)
    if u.shape != (H, K):
        raise ValueError(f"{name}: u {tuple(u.shape)} must be ({H}, {K})")
    for arg in ("state0", "out_state"):
        if arg in tensors:
            t = tensors[arg]
            _build.check_cuda_operands(name, dtypes=(torch.float32,), **{arg: t})
            if t.shape != (Bb, H, K, K):
                raise ValueError(f"{name}: {arg} {tuple(t.shape)} must be ({Bb}, {H}, {K}, {K})")
    # Each block reads its columns of state0 before its time loop and writes
    # the same columns of the output after it, so the output may be state0
    # itself; a partial overlap would let one block read what another wrote.
    if (out_state is not None and state0 is not None and out_state.data_ptr() != state0.data_ptr()
            and _overlap(out_state, state0)):
        raise ValueError(f"{name}: out_state overlaps state0 without being it")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(f"{name}: K7 has no backward yet; the ssm family's "
                                  f"training is not ported")
    return Bb, T, H, K


def _overlap(a, b) -> bool:
    """Whether two contiguous tensors share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def rwkv6_scan(r, k, v, w, u, state0=None, *, out_state=None):
    """The WKV recurrence of one time-mix layer (see the module docstring), one launch."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, state0, out_state=out_state)
    name = "rwkv6_scan"
    if r.device.type != "cuda":
        raise ValueError(f"{name}: r is on {r.device}, expected a CUDA tensor")
    Bb, T, H, K = _check(name, r, k, v, w, u, state0, out_state)
    y = torch.empty((Bb, T, H, K), dtype=r.dtype, device=r.device)
    s_out = (torch.empty((Bb, H, K, K), dtype=torch.float32, device=r.device)
             if out_state is None else out_state)
    fn = _build.load("rwkv6_scan", _ARGTYPES).rwkv6_scan_fwd
    status = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                None if state0 is None else state0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                int(r.dtype == torch.bfloat16), Bb, T, H, K,
                *r.stride(), *k.stride(), *v.stride(), *w.stride(), _build.stream_of(r))
    _build.check_status(name, status)
    rwkv6_scan.launches += 1
    return y, s_out


rwkv6_scan.launches = 0
