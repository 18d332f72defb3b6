"""RWKV-6 WKV recurrence (per-channel data-dependent decay and bonus): K7.

* `rwkv6_scan` (K7) ports the TPU kernel `repro.kernels.rwkv6_scan.rwkv6_scan`
  (src/repro/kernels/rwkv6_scan.py:58) as a CUDA C++ kernel for Hopper
  (`csrc/rwkv6_scan.cu`: a block per (head, batch row), each thread holding
  8 rows x 4 columns of the state in registers, the bonus as one scalar a
  step, 32-step tiles of r, k, w and v landing in two shared-memory slots
  by TMA, float32 FMA; T = 1 takes a one-step kernel with nothing staged;
  built by `kernels._build`).  It is the scan of every time-mix layer
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

Decode calls K7 24 times a step at T = 1, where the device takes a few
microseconds a call, so the wrapper keeps its host time small: the operand
checks run once for each distinct signature (shapes, strides, dtypes,
devices) and the shapes and strides go to the kernel packed in one cached
array; what depends on the call itself (autograd, the overlap of out_state
and state0) is checked every call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SHAPES = (8, 16, 32, 64)  # K = V built: rwkv6's head size 64 and the reference's test sizes
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = {"rwkv6_scan_fwd": [_P] * 8 + [ctypes.POINTER(_L), _P]}
_SIGNATURES: dict = {}  # operand signature -> (state shape, packed dims)
_MAX_SIGNATURES = 256


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
    """Raise unless the operands' shapes, dtypes and devices are what K7
    takes (once a signature); returns (B, T, H, K)."""
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
    return Bb, T, H, K


def _signature(r, k, v, w, u, state0, out_state):
    """What the operand checks depend on, besides the pointers: shapes,
    strides, dtypes and devices (one flat tuple, cheap to build and hash)."""
    return (r.shape, r.stride(), k.shape, k.stride(), v.shape, v.stride(), w.shape, w.stride(),
            r.dtype, k.dtype, v.dtype, w.dtype, r.device, k.device, v.device, w.device,
            u.shape, u.stride(), u.dtype, u.device,
            None if state0 is None else (state0.shape, state0.stride(), state0.dtype,
                                         state0.device),
            None if out_state is None else "state0" if out_state is state0 else (
                out_state.shape, out_state.stride(), out_state.dtype, out_state.device))


def _packed(r, k, v, w):
    """The kernel's dims: is_bf16, B, T, H, K, then r's, k's, v's and w's strides."""
    dims = [int(r.dtype == torch.bfloat16), *r.shape, *r.stride(), *k.stride(), *v.stride(),
            *w.stride()]
    return (_L * len(dims))(*dims)


def rwkv6_scan(r, k, v, w, u, state0=None, *, out_state=None):
    """The WKV recurrence of one time-mix layer (see the module docstring), one launch."""
    name = "rwkv6_scan"
    if not r.is_cuda:
        if r.device.type == "cpu":
            return rwkv6_scan_plain(r, k, v, w, u, state0, out_state=out_state)
        raise ValueError(f"{name}: r is on {r.device}, expected a CUDA tensor")
    key = _signature(r, k, v, w, u, state0, out_state)
    entry = _SIGNATURES.get(key)
    if entry is None:
        _check(name, r, k, v, w, u, state0, out_state)
        if len(_SIGNATURES) >= _MAX_SIGNATURES:
            _SIGNATURES.clear()
        Bb, _, H, K = r.shape
        entry = _SIGNATURES[key] = ((Bb, H, K, K), _packed(r, k, v, w))
    if torch.is_grad_enabled() and (
            r.requires_grad or k.requires_grad or v.requires_grad or w.requires_grad
            or u.requires_grad or (state0 is not None and state0.requires_grad)
            or (out_state is not None and out_state.requires_grad)):
        raise NotImplementedError(f"{name}: K7 has no backward yet; the ssm family's "
                                  f"training is not ported")
    # Each block reads its (b, h) state before its time loop and writes it
    # after, so the output may be state0 itself; a partial overlap would let
    # one block read what another wrote.
    if out_state is not None and state0 is not None:
        a0, b0 = out_state.data_ptr(), state0.data_ptr()
        nbytes = state0.numel() * 4
        if a0 != b0 and a0 < b0 + nbytes and b0 < a0 + nbytes:
            raise ValueError(f"{name}: out_state overlaps state0 without being it")
    s_shape, dims = entry
    # y has r's shape (V = K), dtype and device, contiguous; empty_like is
    # the cheapest allocation on the host.
    y = torch.empty_like(r, memory_format=torch.contiguous_format)
    s_out = (torch.empty(s_shape, dtype=torch.float32, device=r.device) if out_state is None
             else out_state)
    status = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                       None if state0 is None else state0.data_ptr(), y.data_ptr(),
                       s_out.data_ptr(), dims, _build.stream_of(r))
    _build.check_status(name, status)
    rwkv6_scan.launches += 1
    return y, s_out


_fn = None


def _kernel():
    """The bound `rwkv6_scan_fwd` (built and loaded at first use)."""
    global _fn
    if _fn is None:
        _fn = _build.load("rwkv6_scan", _ARGTYPES).rwkv6_scan_fwd
    return _fn


rwkv6_scan.launches = 0
