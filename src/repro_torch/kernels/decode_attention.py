"""Single-token decode attention against a KV cache (full or ring buffer).

Port of the TPU kernel `repro.kernels.decode_attention.decode_attention`
(src/repro/kernels/decode_attention.py:62) as a CUDA C++ kernel for Hopper
(`csrc/decode_attention.cu`: one block per (kv head, batch row), the G query
heads of a kv head sharing one pass over the cache; built by
`kernels._build`).  It is the attention of every decode step
(`models.layers.attn_decode_apply`), and so of every token `BatchServer`
feeds, prompt tokens included.

q is ``(B, 1, H, Dh)``, the caches ``(B, S, KVH, Dh)`` and ``valid`` an
``(S,)`` bool vector shared by the batch, computed by the caller (a prefix
for a full cache, a scattered set for a ring buffer).  q and the caches may
differ in dtype (bfloat16 or float32 each); all arithmetic is float32 and
the output has q's dtype.

`decode_attention` launches the kernel for CUDA tensors and counts each
launch in ``decode_attention.launches``; for CPU tensors it runs the plain
PyTorch version `decode_attention_plain` (and counts nothing).  A CUDA
tensor the kernel does not take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 80, 128)
MAX_GROUP = 8  # query heads per kv head the kernel holds in registers
_P = ctypes.c_void_p
_i = ctypes.c_int
_ARGTYPES = {
    "decode_attention_fwd": [_P, _P, _P, _P, _P, _i, _i, _i, _i, _i, _i, _i, ctypes.c_float, _P],
}


def decode_attention_plain(q, k_cache, v_cache, valid):
    """The plain version (the reference's `ref.naive_decode_attention`)."""
    B, _, H, Dh = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qg = q.reshape(B, KVH, G, Dh).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(Dh)
    scores = scores.masked_fill(~valid[None, None, None], -math.inf)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid):
    """One query row per (batch row, head) against the cache, one launch."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid)
    name = "decode_attention"
    q_dtype = _build.check_cuda_operands(name, dtypes=_build.ATTENTION_DTYPES, q=q)
    c_dtype = _build.check_cuda_operands(name, dtypes=_build.ATTENTION_DTYPES,
                                         k_cache=k_cache, v_cache=v_cache)
    if k_cache.device != q.device or valid.device != q.device:
        raise ValueError(f"{name}: q, the caches and valid must share one device")
    if (q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[3]):
        raise ValueError(f"{name}: expected q (B, 1, H, Dh) and caches (B, S, KVH, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, Dh = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    if valid.dtype != torch.bool or valid.shape != (S,) or not valid.is_contiguous():
        raise ValueError(f"{name}: valid must be a contiguous ({S},) bool tensor, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if KVH == 0 or H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"{name}: {H} query heads over {KVH} kv heads; the kernel takes "
                         f"groups of at most {MAX_GROUP}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not built; the kernel takes {HEAD_DIMS}")
    _build.check_aligned(name, q=q, k_cache=k_cache, v_cache=v_cache)
    out = torch.empty_like(q)
    fn = _build.load("decode_attention", _ARGTYPES).decode_attention_fwd
    status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
                out.data_ptr(), int(q_dtype == torch.bfloat16), int(c_dtype == torch.bfloat16),
                B, S, H, KVH, Dh, Dh**-0.5, _build.stream_of(q))
    _build.check_status(name, status)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
