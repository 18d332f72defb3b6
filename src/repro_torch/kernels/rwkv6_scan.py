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
falls back.

* `rwkv6_scan_bwd` (K7b) is the backward, written by hand
  (`csrc/rwkv6_scan_bwd.cu`).  The reference has no TPU kernel for it: its
  gradient is autodiff through `ref.rwkv6_scan`'s `lax.scan`.  Its chunks of
  K7_CHUNK steps run in parallel: their increments (the state and its
  cotangent run from zero through the chunk), a float32 combine over the
  chunks (the state entering and the cotangent leaving each), the chunks'
  bodies (each chunk's states recomputed, then swept back; dw reads S_{t-1},
  never S_t / w_t, since w can be ~0), and du's sum; four launches, every
  sum in a fixed order.  `rwkv6_scan_bwd_plain` is its plain version: the
  reverse recurrence written out in PyTorch (not autograd), every state of
  the forward kept; `rwkv6_scan_bwd_chunked_plain` is the kernel's
  arithmetic in the kernel's order, for the tests.
* `RWKV6Scan` is the `torch.autograd.Function` of the two, which
  `kernels.ops.rwkv6_scan` takes when an input needs a gradient: K7 forward
  and K7b backward on the card, the plain versions of both on the CPU (in
  float64 for float64 inputs).  Called directly on CUDA tensors that need a
  gradient, `rwkv6_scan` raises rather than return an output autograd
  cannot follow.

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
_BWD_ARGTYPES = {"rwkv6_scan_bwd": [_P] * 15 + [ctypes.POINTER(_L), _P]}
K7_CHUNK = 32  # csrc/rwkv6_scan_bwd.cu kC: K7b's chunks, run in parallel
# Planted faults for chip_smoke.py's checks (False in every real run): K7b's
# combine leaves out what enters each chunk (the state and its cotangent
# start every chunk but the first from zero), and K7b's dw reads S_t for
# S_{t-1}.
_BWD_DROP_CARRY = False
_BWD_DW_FROM_NEXT_STATE = False
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
    if _build.needs_grad(r, k, v, w, u, state0, out_state):
        raise RuntimeError(f"{name}: an input needs a gradient; differentiate through "
                           f"ops.rwkv6_scan (RWKV6Scan: K7 forward, K7b backward)")
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


def rwkv6_scan_bwd_plain(r, k, v, w, u, state0, dy, dstate=None, *, acc_dtype=torch.float32):
    """The plain backward: the gradients of `rwkv6_scan_plain` at its inputs
    for the cotangents ``dy`` of y and ``dstate`` of the final state (None:
    zero), by the reverse recurrence K7b runs (csrc/rwkv6_scan_bwd.cu),
    written out in PyTorch in ``acc_dtype`` with every state of the forward
    kept.  Returns ``(dr, dk, dv, dw, du, dstate0)``, each in its input's
    dtype (du summed over B and T; dstate0 None without state0)."""
    Bb, T, H, K = r.shape
    V = v.shape[-1]
    f = acc_dtype
    r_, k_, v_, w_, dy_ = (a.to(f) for a in (r, k, v, w, dy))
    u_ = u.to(f)
    S = (torch.zeros((Bb, H, K, V), dtype=f, device=r.device) if state0 is None
         else state0.to(f))
    prev = []  # S_{t-1} of every step
    for t in range(T):
        prev.append(S)
        S = w_[:, t, :, :, None] * S + k_[:, t, :, :, None] * v_[:, t, :, None, :]
    dS = torch.zeros((Bb, H, K, V), dtype=f, device=r.device) if dstate is None else dstate.to(f)
    dr, dk, dv, dw = (torch.empty((Bb, T, H, n), dtype=f, device=r.device) for n in (K, K, V, K))
    du = torch.zeros((H, K), dtype=f, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dyt = r_[:, t], k_[:, t], v_[:, t], w_[:, t], dy_[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)  # (B, H, 1)
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", prev[t], dyt) + u_ * kt * vdy
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", dS, vt) + u_ * rt * vdy
        dv[:, t] = (torch.einsum("bhkv,bhk->bhv", dS, kt)
                    + (rt * u_ * kt).sum(-1, keepdim=True) * dyt)
        dw[:, t] = (dS * prev[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        dS = wt[..., None] * dS + rt[..., None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype),
            None if state0 is None else dS.to(state0.dtype))


def rwkv6_scan_bwd_chunked_plain(r, k, v, w, u, state0, dy, dstate=None, *, chunk=K7_CHUNK,
                                 drop_carry=False, acc_dtype=torch.float32):
    """K7b's arithmetic on the CPU, in its order: the chunks' increments
    (each chunk of ``chunk`` steps run from zero, forward for the state and
    in reverse for its cotangent, with its decay product), the combine over
    the chunks (the state entering and the cotangent leaving each), then
    every chunk's body (its states recomputed from what enters it, the sweep
    back from what leaves it) and du's sum.  Steps past T are the identity
    (w 1, the rest 0).  With ``drop_carry`` the combine leaves out what
    enters each chunk: every chunk but the first starts its state, and every
    chunk but the last its cotangent, from zero (the planted fault
    `_BWD_DROP_CARRY`).  The same
    result as `rwkv6_scan_bwd_plain` up to rounding; the tests use it as
    the evidence that the decomposition is right, the main path never."""
    Bb, T, H, K = r.shape
    V = v.shape[-1]
    f = acc_dtype
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def chunks(a, fill):  # (B, T, H, n) -> (B, nc, chunk, H, n), steps past T as `fill`
        a = torch.cat([a.to(f), a.new_full((Bb, pad, H, a.shape[-1]), fill, dtype=f)], dim=1)
        return a.reshape(Bb, nc, chunk, H, a.shape[-1])

    r_, k_, v_, dy_ = (chunks(a, 0.0) for a in (r, k, v, dy))
    w_ = chunks(w, 1.0)
    u_ = u.to(f)
    zeros = torch.zeros((Bb, nc, H, K, V), dtype=f, device=r.device)
    # 1. increments: dS_c and dG_c from zero, W_c the chunk's decay
    dS, dG, W = zeros, zeros, torch.ones((Bb, nc, H, K), dtype=f, device=r.device)
    for l in range(chunk):
        dS = w_[:, :, l, :, :, None] * dS + k_[:, :, l, :, :, None] * v_[:, :, l, :, None, :]
        W = W * w_[:, :, l]
    for l in reversed(range(chunk)):
        dG = w_[:, :, l, :, :, None] * dG + r_[:, :, l, :, :, None] * dy_[:, :, l, :, None, :]
    # 2. combine: S entering and G leaving every chunk
    S = (torch.zeros((Bb, H, K, V), dtype=f, device=r.device) if state0 is None
         else state0.to(f))
    enter = []
    for c in range(nc):
        enter.append(S)
        S = torch.zeros_like(S) if drop_carry else W[:, c, ..., None] * S + dS[:, c]
    G = torch.zeros((Bb, H, K, V), dtype=f, device=r.device) if dstate is None else dstate.to(f)
    leave = [None] * nc
    for c in reversed(range(nc)):
        leave[c] = G
        G = torch.zeros_like(G) if drop_carry else W[:, c, ..., None] * G + dG[:, c]
    dS0 = G
    # 3. bodies, every chunk at once
    S, G = torch.stack(enter, 1), torch.stack(leave, 1)
    vdy = (v_ * dy_).sum(-1, keepdim=True)  # (B, nc, chunk, H, 1)
    prev, dr = [], torch.empty_like(r_)
    for l in range(chunk):
        prev.append(S)
        dr[:, :, l] = (torch.einsum("bchkv,bchv->bchk", S, dy_[:, :, l])
                       + u_ * k_[:, :, l] * vdy[:, :, l])
        S = w_[:, :, l, :, :, None] * S + k_[:, :, l, :, :, None] * v_[:, :, l, :, None, :]
    dk, dv, dw = torch.empty_like(k_), torch.empty_like(v_), torch.empty_like(w_)
    for l in reversed(range(chunk)):
        rt, kt, vt, dyt = r_[:, :, l], k_[:, :, l], v_[:, :, l], dy_[:, :, l]
        dk[:, :, l] = torch.einsum("bchkv,bchv->bchk", G, vt) + u_ * rt * vdy[:, :, l]
        dv[:, :, l] = (torch.einsum("bchkv,bchk->bchv", G, kt)
                       + (rt * u_ * kt).sum(-1, keepdim=True) * dyt)
        dw[:, :, l] = (G * prev[l]).sum(-1)
        G = w_[:, :, l, :, :, None] * G + rt[..., None] * dyt[..., None, :]
    # 4. du
    du = (r_ * k_ * vdy).sum((0, 1, 2))

    def out(a, like):
        return a.reshape(Bb, nc * chunk, H, a.shape[-1])[:, :T].to(like.dtype)

    return (out(dr, r), out(dk, k), out(dv, v), out(dw, w), du.to(u.dtype),
            None if state0 is None else dS0.to(state0.dtype))


def _rows_by_16_bytes(t):
    """Whether K7b can stage ``t`` by 16-byte loads: each row contiguous,
    the tensor and every row 16-byte aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1]))


def _staged(t, *, contiguous=False):
    """``t`` itself when K7b reads it as it lies (16-byte rows, contiguous
    when asked), else a fresh contiguous copy."""
    if _rows_by_16_bytes(t) and (t.is_contiguous() or not contiguous):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_dims(r, k, v, w):
    dims = [*_packed(r, k, v, w), int(_BWD_DROP_CARRY), int(_BWD_DW_FROM_NEXT_STATE)]
    return (_L * len(dims))(*dims)


def bwd_scratch_elements(B: int, T: int, H: int, K: int) -> int:
    """K7b's float32 scratch: the chunks' increments of the state and of its
    cotangent (B, H, nc, K, K) each, the chunks' decays and du's partials
    (B, H, nc, K) each, each step's v . dy and sum of r u k (B, H, nc, 2,
    K7_CHUNK), nc = ceil(T / K7_CHUNK)."""
    return 2 * B * H * -(-T // K7_CHUNK) * (K * K + K + K7_CHUNK)


def rwkv6_scan_bwd(r, k, v, w, u, state0, dy, dstate=None):
    """The gradients of `rwkv6_scan` at its inputs for the cotangents ``dy``
    (B, T, H, V) of y and ``dstate`` (B, H, K, V, or None: zero) of the final
    state: ``(dr, dk, dv, dw, du, dstate0)`` (see `rwkv6_scan_bwd_plain`),
    one call of K7b (four launches: the chunks' increments, their combine,
    the chunks' bodies, du's sum; see `rwkv6_scan_bwd_chunked_plain`)."""
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_plain(r, k, v, w, u, state0, dy, dstate)
    name = "rwkv6_scan_bwd"
    if r.device.type != "cuda":
        raise ValueError(f"{name}: r is on {r.device}, expected a CUDA tensor")
    Bb, T, H, K = _check(name, r, k, v, w, u, state0)
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device:
        raise ValueError(f"{name}: dy is {dy.dtype} {tuple(dy.shape)} on {dy.device}; it must "
                         f"be {r.dtype} {tuple(r.shape)} on {r.device}")
    # K7b stages every operand by 16-byte loads, so an operand whose rows
    # are not contiguous and 16-byte aligned is copied (the model's packed
    # column views are taken as they lie); dy must be contiguous too.
    r, k, v, w = (_staged(t) for t in (r, k, v, w))
    dy = _staged(dy, contiguous=True)
    if dstate is not None:
        _build.check_cuda_operands(name, dtypes=(torch.float32,), dstate=dstate)
        if dstate.shape != (Bb, H, K, K):
            raise ValueError(f"{name}: dstate {tuple(dstate.shape)} must be ({Bb}, {H}, {K}, {K})")
        _build.check_aligned(name, dstate=dstate)
    if state0 is not None:
        _build.check_aligned(name, state0=state0)  # the combine reads 16 bytes a thread
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = torch.empty((4, Bb, T, H, K), dtype=r.dtype, device=r.device)
    du = torch.empty((H, K), **f32)
    ds0 = None if state0 is None else torch.empty((Bb, H, K, K), **f32)
    scratch = torch.empty(bwd_scratch_elements(Bb, T, H, K), **f32)
    fn = _build.load("rwkv6_scan_bwd", _BWD_ARGTYPES).rwkv6_scan_bwd
    status = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                None if state0 is None else state0.data_ptr(), dy.data_ptr(),
                None if dstate is None else dstate.data_ptr(), grads[0].data_ptr(),
                grads[1].data_ptr(), grads[2].data_ptr(), grads[3].data_ptr(), du.data_ptr(),
                None if ds0 is None else ds0.data_ptr(), scratch.data_ptr(),
                _bwd_dims(r, k, v, w), _build.stream_of(r))
    _build.check_status(name, status)
    rwkv6_scan_bwd.launches += 1
    return grads[0], grads[1], grads[2], grads[3], du, ds0


rwkv6_scan_bwd.launches = 0


class RWKV6Scan(torch.autograd.Function):
    """The WKV scan with a gradient: K7 forward, K7b backward; on CPU tensors
    the plain versions of both (float64 arithmetic for float64 inputs).
    Returns ``(y, state)``; either output may carry a cotangent."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        if r.device.type == "cpu":
            acc = torch.float64 if r.dtype == torch.float64 else torch.float32
            y, S = rwkv6_scan_plain(r, k, v, w, u, state0, acc_dtype=acc)
            ctx.acc = acc
        else:
            y, S = rwkv6_scan(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.set_materialize_grads(False)
        return y, S

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype)
        if r.device.type == "cpu":
            return rwkv6_scan_bwd_plain(r, k, v, w, u, state0, dy, dstate, acc_dtype=ctx.acc)
        if dstate is not None:
            dstate = dstate.float().contiguous()
        return rwkv6_scan_bwd(r, k, v, w, u, state0, dy, dstate)
