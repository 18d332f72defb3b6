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
back.

* `ssm_scan_bwd` (K6b) is the backward, written by hand
  (`csrc/ssm_scan_bwd.cu`).  The reference has no TPU kernel for it: its
  gradient is autodiff through `ssm_scan_chunked`.  The route depends on
  dtype and (P, N) alone (`bwd_route`): bf16 at P = N = 64 runs the chunks
  in parallel on tensor cores (four launches: each chunk's local state and
  cotangent increments, a float32 pass over the chunks that combines them,
  the chunk bodies with a group of heads a block, the sums over head groups
  and chunks); float32 and P 128 / N 16 run the first design (two launches:
  one float32 FMA block a (head, batch row) recomputing the chunk states
  and walking the chunks in reverse, then the sums).  Every sum over heads,
  rows and chunks is in a fixed order (bit-reproducible).
  `ssm_scan_bwd_plain` is its plain version, the same chunked formulas in
  PyTorch (not autograd), at the plain forward's 128-step chunk;
  `ssm_scan_bwd_split_plain` models the tensor-core route's arithmetic.
* `SSMScan` is the `torch.autograd.Function` of the two, which
  `kernels.ops.ssm_scan` takes when an input needs a gradient: K6 forward and
  K6b backward on the card, the plain versions of both on the CPU (in
  float64 for float64 inputs, so `torch.autograd.gradcheck` can hold them).
  Called directly on CUDA tensors that need a gradient, `ssm_scan` raises
  rather than return an output autograd cannot follow.
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
_BWD_ARGTYPES = {"ssm_scan_bwd": [_P] * 17 + [_i] * 6 + [_L] * 13 + [_i, _P],
                 "ssm_scan_bwd_tc": [_P] * 17 + [_i] * 4 + [_L] * 13 + [_i, _P]}
BWD_MAX_GROUP = 16  # the tensor-core K6b's heads a body block, at most
BWD_BLOCKS_A_WAVE = 2 * 132  # its body blocks resident at once on an H100 (two an SM)

# Planted fault for chip_smoke.py's checks: the tensor-core route leaves out
# the low bf16 parts of its split operands (False in every real run).
_DROP_LOW_HALF = False
# Planted fault for chip_smoke.py's checks: K6b does not carry the state's
# cotangent from a chunk to the one before (False in every real run).
_BWD_DROP_CARRY = False


def scan_route(dtype: torch.dtype, P: int, N: int) -> str:
    """Which K6 kernel a CUDA call runs (`ssm_scan_fwd` in csrc/ssm_scan.cu
    chooses by the same rule): "tensor_core" for bf16 at (P, N) = (64, 64),
    "fma_f32" otherwise."""
    return "tensor_core" if dtype == torch.bfloat16 and (P, N) == TENSOR_CORE_SHAPE else "fma_f32"


def bwd_route(dtype: torch.dtype, P: int, N: int) -> str:
    """Which K6b kernels a CUDA call runs (`ssm_scan_bwd` chooses by the same
    rule): K6's rule, "tensor_core" (chunks in parallel) for bf16 at (P, N) =
    (64, 64), "fma_f32" (the first design) otherwise."""
    return scan_route(dtype, P, N)


def bwd_group(B: int, T: int, H: int) -> int:
    """Heads a body block of the tensor-core K6b: the divisor g of H up to
    BWD_MAX_GROUP that keeps the fewest head-chunks on the busiest SM, with
    BWD_BLOCKS_A_WAVE blocks resident at once and a block's shared C B^T and
    B, C staging costed as one head more; the largest g of the ties (fewer
    partials).  Zamba2's training shape (2, 1024, 80): 10, 256 blocks in one
    wave (8 would leave a second wave 56 blocks wide)."""
    blocks = B * -(-T // K6_CHUNK) * H

    def cost(g):
        return -(-blocks // g // BWD_BLOCKS_A_WAVE) * (g + 1), -g

    return min((g for g in range(1, min(H, BWD_MAX_GROUP) + 1) if H % g == 0), key=cost)


def ssm_scan_plain(x, dt, A, B_mat, C_mat, D, state0=None, *, acc_dtype=torch.float32):
    """The plain version: the reference's `ssm_scan_chunked`, chunk by
    chunk in float32 (intra-chunk products masked before the exponent); with
    ``acc_dtype=torch.float64`` in float64, the state returned in it."""
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    f32 = acc_dtype
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
    return Bb, T, H, P, N


def ssm_scan(x, dt, A, B_mat, C_mat, D, state0=None):
    """The scan of one Mamba-2 layer (see the module docstring), one launch."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B_mat, C_mat, D, state0)
    name = "ssm_scan"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, expected a CUDA tensor")
    Bb, T, H, P, N = _check(name, x, dt, A, B_mat, C_mat, D, state0)
    if _build.needs_grad(x, dt, A, B_mat, C_mat, D, state0):
        raise RuntimeError(f"{name}: an input needs a gradient; differentiate through "
                           f"ops.ssm_scan (SSMScan: K6 forward, K6b backward)")
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


def ssm_scan_bwd_plain(x, dt, A, B_mat, C_mat, D, state0, dy, dstate=None, *,
                       chunk=PLAIN_CHUNK, acc_dtype=torch.float32):
    """The plain backward: the gradients of `ssm_scan_plain` at its inputs
    for the cotangents ``dy`` of y and ``dstate`` of the final state (None:
    zero), by the chunked formulas K6b runs (csrc/ssm_scan_bwd.cu), written
    out in PyTorch, at ``chunk`` steps a chunk, in ``acc_dtype``.  Returns
    ``(dx, ddt, dA, dB_mat, dC_mat, dD, dstate0)``, each in its input's
    dtype (dstate0 None without state0)."""
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    f = acc_dtype
    Q = min(chunk, T)
    pad = (-T) % Q
    xf, dtf, Bm, Cm = x.to(f), dt.to(f), B_mat.to(f), C_mat.to(f)
    dyf = dy.to(f)
    if pad:
        xf, dyf = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    A_, D_ = A.to(f), D.to(f)
    dev = x.device
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()[None, :, :, None]
    below = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril(-1)[None, :, :, None]
    chunks = range(0, T + pad, Q)

    def decay(dtq):
        cum = torch.cumsum(A_ * dtq, dim=1)  # (B, Q, H), inclusive
        last = cum[:, -1]  # (B, H)
        return cum, last, torch.exp(last[:, None] - cum) * dtq  # ws (B, Q, H)

    # the state entering every chunk
    h = torch.zeros((Bb, H, P, N), dtype=f, device=dev) if state0 is None else state0.to(f)
    states = []
    for c0 in chunks:
        states.append(h)
        _, last, ws = decay(dtf[:, c0:c0 + Q])
        h = (torch.exp(last)[:, :, None, None] * h
             + torch.einsum("bshp,bsn->bhpn", ws[..., None] * xf[:, c0:c0 + Q], Bm[:, c0:c0 + Q]))

    dh = torch.zeros((Bb, H, P, N), dtype=f, device=dev) if dstate is None else dstate.to(f)
    dxs, ddts, dBs, dCs = [], [], [], []
    dA = torch.zeros((H,), dtype=f, device=dev)
    dD = torch.zeros((H,), dtype=f, device=dev)
    for c0, h in zip(reversed(chunks), reversed(states)):
        xq, dyq, dtq = xf[:, c0:c0 + Q], dyf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        Bq, Cq = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        cum, last, ws = decay(dtq)
        ec = torch.exp(cum)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, H)
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        CB = torch.einsum("btn,bsn->bts", Cq, Bq)[..., None]
        M = torch.einsum("bthp,bshp->btsh", dyq, xq)
        dts = dtq[:, None, :, :]
        G, Fm, LCM = L * CB * dts, L * M * dts, L * CB * M
        dxs.append(torch.einsum("btsh,bthp->bshp", G, dyq) + D_[:, None] * dyq
                   + ws[..., None] * torch.einsum("bsn,bhpn->bshp", Bq, dh))
        dyh = torch.einsum("bthp,bhpn->bthn", dyq, h)
        dCs.append(torch.einsum("btsh,bsn->btn", Fm, Bq) + torch.einsum("bth,bthn->btn", ec, dyh))
        xdh = torch.einsum("bshp,bhpn->bshn", xq, dh)
        dBs.append(torch.einsum("btsh,btn->bsn", Fm, Cq) + torch.einsum("bsh,bshn->bsn", ws, xdh))
        dws = torch.einsum("bsn,bshn->bsh", Bq, xdh)
        direct = LCM.sum(1)  # (B, s, H)
        # da[j]: E's rectangle t >= j, s < j; dws ws over s < j; the reads of
        # exp(cum[t]) over t >= j; exp(cum[-1]) (see csrc/ssm_scan_bwd.cu)
        E = torch.where(below, LCM * dts, 0.0)
        suffix = torch.flip(torch.cumsum(torch.flip(E, (1,)), 1), (1,))  # over t' >= t
        rect = torch.where(below, suffix, 0.0).sum(2)  # (B, t, H)
        qv = dws * ws
        dcum = ec * torch.einsum("btn,bthn->bth", Cq, dyh)
        dcum[:, -1] += torch.exp(last) * (dh * h).sum((-2, -1))
        da = (torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,)) + rect
              + torch.cumsum(qv, 1) - qv)
        ddts.append(direct + dws * torch.exp(last[:, None] - cum) + A_ * da)
        dA += (da * dtq).sum((0, 1))
        dD += (dyq * xq).sum((0, 1, 3))
        dh = (torch.exp(last)[:, :, None, None] * dh
              + torch.einsum("bth,bthp,btn->bhpn", ec, dyq, Cq))

    def cat(parts, like):
        return torch.cat(parts[::-1], dim=1)[:, :T].to(like.dtype)

    return (cat(dxs, x), cat(ddts, dt), dA.to(A.dtype), cat(dBs, B_mat), cat(dCs, C_mat),
            dD.to(D.dtype), None if state0 is None else dh.to(state0.dtype))


def ssm_scan_bwd_split_plain(x, dt, A, B_mat, C_mat, D, state0, dy, dstate=None, *,
                             drop_low=False):
    """The tensor-core K6b's arithmetic in plain PyTorch (float32): 64-step
    chunks; each chunk's increments S_c = (ws o X)^T B and R_c = (exp(cum) o
    dY)^T C formed alone, then combined over the chunks with the decays
    exp(cum[-1]); every float32 operand of a product (ws o X, exp(cum) o dY,
    G, F, E, h, dh) replaced by its bf16 high + low split (with
    ``drop_low``, by the high part alone); E's rectangle as the column sums
    over t >= j of RP = E U, U[s][j] = [s < j].  Returns what
    `ssm_scan_bwd_plain` returns."""
    Bb, T, H, P = x.shape
    N = B_mat.shape[-1]
    f = torch.float32
    Q = K6_CHUNK
    pad = (-T) % Q
    xf, dtf, Bm, Cm, dyf = x.to(f), dt.to(f), B_mat.to(f), C_mat.to(f), dy.to(f)
    if pad:
        xf, dyf = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    A_, D_ = A.to(f), D.to(f)
    dev = x.device
    nc = (T + pad) // Q

    def sp(v):
        return _split(v, drop_low)

    def chunk(a, c):
        return a[:, c * Q:(c + 1) * Q]

    cums = [torch.cumsum(A_ * chunk(dtf, c), dim=1) for c in range(nc)]  # (B, Q, H)
    lasts = [cum[:, -1] for cum in cums]  # (B, H)
    wss = [torch.exp(last[:, None] - cum) * chunk(dtf, c)
           for c, (cum, last) in enumerate(zip(cums, lasts))]
    # each chunk's increments alone, then the combine over the chunks
    inc_s = [torch.einsum("bshp,bsn->bhpn", sp(ws[..., None] * chunk(xf, c)), chunk(Bm, c))
             for c, ws in enumerate(wss)]
    inc_r = [torch.einsum("bthp,btn->bhpn", sp(torch.exp(cum)[..., None] * chunk(dyf, c)),
                          chunk(Cm, c)) for c, cum in enumerate(cums)]
    h = torch.zeros((Bb, H, P, N), dtype=f, device=dev) if state0 is None else state0.to(f)
    states = []
    for c in range(nc):
        states.append(h)
        h = torch.exp(lasts[c])[:, :, None, None] * h + inc_s[c]
    dh0 = torch.zeros((Bb, H, P, N), dtype=f, device=dev) if dstate is None else dstate.to(f)
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = dh0
        dh0 = torch.exp(lasts[c])[:, :, None, None] * dh0 + inc_r[c]

    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()[None, :, :, None]
    below = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril(-1)[None, :, :, None]
    ustrict = torch.ones((Q, Q), dtype=f, device=dev).triu(1)  # U[s][j] = [s < j]
    dxs, ddts, dBs, dCs = [], [], [], []
    dA = torch.zeros((H,), dtype=f, device=dev)
    dD = torch.zeros((H,), dtype=f, device=dev)
    for c in range(nc):
        xq, dyq, dtq, Bq, Cq = (chunk(a, c) for a in (xf, dyf, dtf, Bm, Cm))
        cum, last, ws, h, dh = cums[c], lasts[c], wss[c], states[c], dhs[c]
        hs, dhs_ = sp(h), sp(dh)
        ec = torch.exp(cum)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, H)
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        CB = torch.einsum("btn,bsn->bts", Cq, Bq)[..., None]
        M = torch.einsum("bthp,bshp->btsh", dyq, xq)
        dts = dtq[:, None, :, :]
        G, Fm, LCM = sp(L * CB * dts), sp(L * M * dts), L * CB * M
        E = sp(torch.where(below, LCM * dts, 0.0))
        RP = torch.einsum("btsh,sj->btjh", E, ustrict)
        rect = torch.where(tri, RP, 0.0).sum(1)  # (B, j, H): over t >= j
        dxs.append(torch.einsum("btsh,bthp->bshp", G, dyq) + D_[:, None] * dyq
                   + ws[..., None] * torch.einsum("bsn,bhpn->bshp", Bq, dhs_))
        dyh = torch.einsum("bthp,bhpn->bthn", dyq, hs)
        dCs.append(torch.einsum("btsh,bsn->btn", Fm, Bq) + torch.einsum("bth,bthn->btn", ec, dyh))
        xdh = torch.einsum("bshp,bhpn->bshn", xq, dhs_)
        dBs.append(torch.einsum("btsh,btn->bsn", Fm, Cq) + torch.einsum("bsh,bshn->bsn", ws, xdh))
        dws = torch.einsum("bsn,bshn->bsh", Bq, xdh)
        direct = LCM.sum(1)
        qv = dws * ws
        dcum = ec * torch.einsum("btn,bthn->bth", Cq, dyh)
        dcum[:, -1] += torch.exp(last) * (dh * h).sum((-2, -1))
        da = (torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,)) + rect
              + torch.cumsum(qv, 1) - qv)
        ddts.append(direct + dws * torch.exp(last[:, None] - cum) + A_ * da)
        dA += (da * dtq).sum((0, 1))
        dD += (dyq * xq).sum((0, 1, 3))

    def cat(parts, like):
        return torch.cat(parts, dim=1)[:, :T].to(like.dtype)

    return (cat(dxs, x), cat(ddts, dt), dA.to(A.dtype), cat(dBs, B_mat), cat(dCs, C_mat),
            dD.to(D.dtype), None if state0 is None else dh0.to(state0.dtype))


def ssm_scan_bwd(x, dt, A, B_mat, C_mat, D, state0, dy, dstate=None):
    """The gradients of `ssm_scan` at its inputs for the cotangents ``dy``
    (B, T, H, P) of y and ``dstate`` (B, H, P, N, or None: zero) of the final
    state: ``(dx, ddt, dA, dB_mat, dC_mat, dD, dstate0)`` (see
    `ssm_scan_bwd_plain`), one call of K6b (`bwd_route`: four CUDA launches
    on the tensor-core route, two on the first design's)."""
    if x.device.type == "cpu":
        return ssm_scan_bwd_plain(x, dt, A, B_mat, C_mat, D, state0, dy, dstate)
    name = "ssm_scan_bwd"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, expected a CUDA tensor")
    Bb, T, H, P, N = _check(name, x, dt, A, B_mat, C_mat, D, state0)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy is {dy.dtype} {tuple(dy.shape)} on {dy.device}; it must "
                         f"be {x.dtype} {tuple(x.shape)} on {x.device}")
    dy = dy.contiguous()
    if dstate is not None:
        _build.check_cuda_operands(name, dtypes=(torch.float32,), dstate=dstate)
        if dstate.shape != (Bb, H, P, N):
            raise ValueError(f"{name}: dstate {tuple(dstate.shape)} must be ({Bb}, {H}, {P}, {N})")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((Bb, T, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bb, T, H), **f32)
    dBC = torch.empty((2, Bb, T, N), dtype=x.dtype, device=dev)
    dAD = torch.empty((2, H), **f32)
    dh0 = None if state0 is None else torch.empty((Bb, H, P, N), **f32)
    nc = -(-T // K6_CHUNK)
    fns = _build.load("ssm_scan_bwd", _BWD_ARGTYPES)
    if bwd_route(x.dtype, P, N) == "tensor_core":
        group = bwd_group(Bb, T, H)
        # chunk increments then states and cotangents (2 B H nc P N), decays
        # (B H nc), dB / dC partials (2 B H/group T N), dA / dD partials (2 B nc H)
        scratch = torch.empty(2 * Bb * H * nc * P * N + Bb * H * nc
                              + 2 * Bb * (H // group) * T * N + 2 * Bb * nc * H, **f32)
        fn, extra = fns.ssm_scan_bwd_tc, (Bb, T, H, group)
    else:
        scratch = torch.empty(Bb * H * (nc * P * N + 2 * T * N + 2), **f32)
        fn, extra = fns.ssm_scan_bwd, (int(x.dtype == torch.bfloat16), Bb, T, H, P, N)
    status = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
                D.data_ptr(), None if state0 is None else state0.data_ptr(), dy.data_ptr(),
                None if dstate is None else dstate.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                dBC[0].data_ptr(), dBC[1].data_ptr(), dAD[0].data_ptr(), dAD[1].data_ptr(),
                None if dh0 is None else dh0.data_ptr(), scratch.data_ptr(), *extra,
                *x.stride(), *dt.stride(), *B_mat.stride(), *C_mat.stride(),
                int(_BWD_DROP_CARRY), _build.stream_of(x))
    _build.check_status(name, status)
    ssm_scan_bwd.launches += 1
    return dx, ddt, dAD[0], dBC[0], dBC[1], dAD[1], dh0


ssm_scan_bwd.launches = 0


class SSMScan(torch.autograd.Function):
    """The scan with a gradient: K6 forward, K6b backward; on CPU tensors the
    plain versions of both (float64 arithmetic for float64 inputs).  Returns
    ``(y, state)``; either output may carry a cotangent."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, D, state0):
        if x.device.type == "cpu":
            acc = torch.float64 if x.dtype == torch.float64 else torch.float32
            y, h = ssm_scan_plain(x, dt, A, B_mat, C_mat, D, state0, acc_dtype=acc)
            ctx.acc = acc
        else:
            y, h = ssm_scan(x, dt, A, B_mat, C_mat, D, state0)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, D, state0)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_mat, C_mat, D, state0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        if x.device.type == "cpu":
            return ssm_scan_bwd_plain(x, dt, A, B_mat, C_mat, D, state0, dy, dstate,
                                      acc_dtype=ctx.acc)
        if dstate is not None:
            dstate = dstate.float().contiguous()
        return ssm_scan_bwd(x, dt, A, B_mat, C_mat, D, state0, dy, dstate)
