"""GQA attention over a full sequence, forward and backward.

* `flash_attention` (K4) ports the TPU kernel
  `repro.kernels.flash_attention.flash_attention`
  (src/repro/kernels/flash_attention.py:105) as CUDA C++ kernels for Hopper
  (`csrc/flash_attention.cu`, built by `kernels._build`), the key loop
  inside the block.  The route depends on dtype alone (`forward_route`):
  bf16 runs a persistent, warp-specialised kernel (TMA loads by a producer
  warpgroup, `wgmma` in two consumer warpgroups; rows in 64-column boxes with
  the 128-byte swizzle at Dh 64 and 128, in 16-column boxes with the 32-byte
  swizzle at Dh 80), float32 the FMA kernel.  With
  ``with_lse=True`` it also returns the softmax log-sum-exp of every row.
* `flash_attention_bwd` (K4b) is the backward, written by hand
  (`csrc/flash_attention_bwd.cu`).  The reference has no TPU kernel for it:
  its gradient is the jnp `custom_vjp` `_ca_bwd`
  (src/repro/kernels/ops.py:105), which recomputes each score block from the
  saved log-sum-exp and never builds an (S, S) tensor.  Its route depends on
  dtype and group alone (`backward_route`): bf16 at Dh 64, 80 and 128 with
  G = H / KVH <= 8 runs one wgmma + TMA kernel with the five products
  (a cluster of the G query heads of a kv head sums dK and dV in shared
  memory; dQ is added across key tiles into a float32 accumulator, so it is
  not bit-reproducible), between a prologue (delta) and an epilogue (dQ in
  bf16) launch; the rest runs the first design's mma.sync / float32 FMA
  kernels.
* `FlashAttention` is the `torch.autograd.Function` of the two (the port of
  `_chunked_attention`'s `custom_vjp`), which `kernels.ops.attention` takes
  when an input needs a gradient.

q is ``(B, Sq, H, Dh)``, k and v ``(B, Skv, KVH, Dh)`` with ``H % KVH == 0``;
query head h reads kv head ``h // (H // KVH)``.  Masking is by absolute
position: row i sits at ``i + q_offset`` and sees key j when j < Skv, j <= its
position if ``causal``, and its position minus j < ``sliding_window`` if one
is given.  The softmax runs in float32 and the output has q's dtype.

The log-sum-exp ``lse`` is ``(B, H, Sq)`` float32 (the reference's
``(B, KVH, G, Sq)``, since h = kvh * G + g), in natural-log units of the
scaled scores.  A row with no allowed key has no log-sum-exp; the plain
version gives the reference's log(1e-37) there and K4 a large negative
sentinel, and the backward, which masks by position, reads neither.

`flash_attention` and `flash_attention_bwd` launch their kernels for CUDA
tensors and count each call in ``.launches``; for CPU tensors they run the
plain PyTorch versions `flash_attention_plain` and
`flash_attention_bwd_plain` (and count nothing).  A CUDA tensor a kernel does
not take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 80, 128)  # the dense zoo's head dims: granite, qwen3, llama/qwen2
_P = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = {
    "flash_attention_fwd": [_P] * 5 + [_i] * 11 + [ctypes.c_float, _P],
}
_BWD_ARGTYPES = {
    "flash_attention_bwd": [_P] * 12 + [_i] * 11 + [ctypes.c_float, _P],
    "flash_attention_bwd_wgmma": [_P] * 10 + [_i] * 11 + [ctypes.c_float, _P],
}
BWD_MAX_GROUP = 8  # the wgmma route's cluster of G blocks (portable cluster size)
EMPTY_ROW_LSE = math.log(1e-37)  # the reference's log-sum-exp of a row with no key


def _mask(Sq, Skv, causal, sliding_window, q_offset, device):
    """(Sq, Skv) bool: which keys each query row may see (absolute positions)."""
    q_pos = torch.arange(Sq, device=device) + q_offset
    k_pos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if sliding_window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < sliding_window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, sliding_window=None, q_offset=0,
                          with_lse=False):
    """The plain version (the reference's `ref.naive_attention`): the whole
    (Sq, Skv) score matrix in float32; a row with no allowed key gives 0.
    With ``with_lse``, returns ``(out, lse)``."""
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, Dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(Dh)
    mask = _mask(Sq, Skv, causal, sliding_window, q_offset, q.device)
    scores = scores.masked_fill(~mask, -math.inf)
    p = torch.softmax(scores, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # rows with no allowed key
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(B, Sq, H, Dh).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.logsumexp(scores, dim=-1)
    lse = lse.masked_fill(torch.isinf(lse), EMPTY_ROW_LSE)
    return o, lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal=True, sliding_window=None,
                              q_offset=0):
    """The plain backward (the reference's `_ca_bwd`, with the whole score
    matrix at once instead of key chunks): ``(dq, dk, dv)`` in the inputs'
    dtypes, every product in float32.  P is recomputed from ``lse`` and
    masked to 0 by position, so a row with no allowed key gets dq = 0 and
    gives nothing to dk and dv."""
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = Dh**-0.5
    qg = q.reshape(B, Sq, KVH, G, Dh).float() * scale
    dog = do.reshape(B, Sq, KVH, G, Dh).float()
    og = out.reshape(B, Sq, KVH, G, Dh).float()
    kf, vf = k.float(), v.float()
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)  # (B, KVH, G, Sq)
    mask = _mask(Sq, Skv, causal, sliding_window, q_offset, q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    p = (s - lse.reshape(B, KVH, G, Sq, 1)).masked_fill(~mask, -math.inf).exp()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(B, Sq, H, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_attention(name, q, k, v, sliding_window, **more):
    """Raise unless the operands are what the attention kernels take."""
    dtype = _build.check_cuda_operands(name, dtypes=_build.ATTENTION_DTYPES, q=q, k=k, v=v,
                                       **more)
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[3] != q.shape[3]):
        raise ValueError(f"{name}: expected q (B, Sq, H, Dh) and k, v (B, Skv, KVH, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if KVH == 0 or H % KVH:
        raise ValueError(f"{name}: {H} query heads do not group over {KVH} kv heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not built; the kernel takes {HEAD_DIMS}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"{name}: sliding_window must be >= 1, got {sliding_window}")
    _build.check_aligned(name, q=q, k=k, v=v, **more)
    return dtype


def forward_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which K4 kernel a CUDA call runs (`launch_dh` in csrc/flash_attention.cu
    chooses by the same rule): "wgmma_tma" for bf16 (head dim 64, 80 or 128),
    "fma_f32" for float32."""
    return "wgmma_tma" if dtype == torch.bfloat16 else "fma_f32"


# Planted fault for chip_smoke.py's checks: K4's wgmma route drops this many
# of the last key tiles of every row block (0 in every real run).
_FWD_SKIP_LAST_KEY_TILES = 0


def flash_attention(q, k, v, *, causal=True, sliding_window=None, q_offset=0, with_lse=False):
    """Attention of ``q`` over ``k``/``v`` (see the module docstring), one
    launch; with ``with_lse``, ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sliding_window=sliding_window,
                                     q_offset=q_offset, with_lse=with_lse)
    name = "flash_attention"
    dtype = _check_attention(name, q, k, v, sliding_window)
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _build.load("flash_attention", _ARGTYPES).flash_attention_fwd
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                int(dtype == torch.bfloat16), B, Sq, Skv, H, KVH, Dh, int(q_offset), int(causal),
                int(sliding_window or 0), _FWD_SKIP_LAST_KEY_TILES, Dh**-0.5, _build.stream_of(q))
    _build.check_status(name, status)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0

# Planted faults for chip_smoke.py's checks (0 and -1 in every real run):
# K4b skips this many 64-key tiles at the start of every row; the wgmma
# route leaves this rank's query head out of each group's dK and dV.
_BWD_SKIP_KEY_TILES = 0
_BWD_DROP_GROUP_RANK = -1


def backward_route(dtype: torch.dtype, head_dim: int, group: int) -> str:
    """Which K4b kernels a CUDA call runs: "wgmma_tma" for bf16 at every
    built head dim (64, 80, 128) with a group of at most BWD_MAX_GROUP query
    heads a kv head, "mma_sync" for the other bf16 calls, "fma_f32" for
    float32."""
    if dtype == torch.bfloat16:
        return "wgmma_tma" if head_dim in HEAD_DIMS and group <= BWD_MAX_GROUP else "mma_sync"
    return "fma_f32"


_BWD_CHECKED: dict = {}  # operand signatures already validated (shapes, strides, dtypes, devices)


def _bwd_signature(q, k, v, out, lse, do, sliding_window):
    return tuple((t.shape, t.stride(), t.dtype, t.device) for t in (q, k, v, out, lse, do)) + (
        sliding_window,)


def _check_bwd(name, q, k, v, out, lse, do, sliding_window):
    """Raise unless the backward's operands are what K4b takes; returns the dtype.
    Shapes, strides and dtypes are checked once a signature, alignment every call."""
    key = _bwd_signature(q, k, v, out, lse, do, sliding_window)
    dtype = _BWD_CHECKED.get(key)
    if dtype is None:
        dtype = _check_attention(name, q, k, v, sliding_window, out=out, do=do)
        B, Sq, H, Dh = q.shape
        if out.shape != q.shape or do.shape != q.shape:
            raise ValueError(f"{name}: out {tuple(out.shape)} and do {tuple(do.shape)} must be "
                             f"shaped like q {tuple(q.shape)}")
        if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq) or not lse.is_contiguous()
                or lse.device != q.device):
            raise ValueError(f"{name}: lse must be a contiguous float32 ({B}, {H}, {Sq}) tensor "
                             f"on {q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
        if len(_BWD_CHECKED) >= 64:
            _BWD_CHECKED.clear()
        _BWD_CHECKED[key] = dtype
    else:
        _build.check_aligned(name, q=q, k=k, v=v, out=out, do=do)
    return dtype


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, sliding_window=None, q_offset=0):
    """The gradients ``(dq, dk, dv)`` of `flash_attention` at ``(q, k, v)``
    for the output gradient ``do``, from the forward's ``out`` and ``lse``:
    one call of K4b (see `backward_route`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                         sliding_window=sliding_window, q_offset=q_offset)
    name = "flash_attention_bwd"
    dtype = _check_bwd(name, q, k, v, out, lse, do, sliding_window)
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dkv = torch.empty((2, *k.shape), dtype=k.dtype, device=k.device)
    dk, dv = dkv[0], dkv[1]
    fns = _build.load("flash_attention_bwd", _BWD_ARGTYPES)
    window = int(sliding_window or 0)
    if backward_route(dtype, Dh, H // KVH) == "wgmma_tma":
        sq_pad = -(-Sq // 64) * 64
        # lse2 and delta (B, H, sq_pad), then the dQ accumulator (B, H, sq_pad, Dh)
        scratch = torch.empty(B * H * sq_pad * (2 + Dh), dtype=torch.float32, device=q.device)
        status = fns.flash_attention_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            B, Sq, Skv, H, KVH, Dh, int(q_offset), int(causal), window, _BWD_SKIP_KEY_TILES,
            _BWD_DROP_GROUP_RANK, Dh**-0.5, _build.stream_of(q))
    else:
        f32 = dict(dtype=torch.float32, device=q.device)
        delta = torch.empty((B, H, Sq), **f32)
        # dK and dV of every query head before the sum over its kv head's group
        dk_h, dv_h = torch.empty((B, Skv, H, Dh), **f32), torch.empty((B, Skv, H, Dh), **f32)
        status = fns.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), dk_h.data_ptr(), dv_h.data_ptr(),
            int(dtype == torch.bfloat16), B, Sq, Skv, H, KVH, Dh, int(q_offset), int(causal),
            window, _BWD_SKIP_KEY_TILES, Dh**-0.5, _build.stream_of(q))
    _build.check_status(name, status)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: K4 forward (saving ``out`` and ``lse``), K4b
    backward; on CPU tensors the plain versions of both.  The port of the
    reference's `_chunked_attention` `custom_vjp` (src/repro/kernels/ops.py:90-155)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, q_offset):
        out, lse = flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                                   q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, sliding_window=sliding_window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None
