"""GQA attention over a full sequence: causal, sliding-window or non-causal.

Port of the TPU kernel `repro.kernels.flash_attention.flash_attention`
(src/repro/kernels/flash_attention.py:105) as a CUDA C++ kernel for Hopper
(`csrc/flash_attention.cu`: tensor-core `mma.sync` for bf16, FMA for
float32, the key loop inside the block; built by `kernels._build`).  It is
the attention of the prefill / full-sequence forward (`models.layers.attn_apply`).

q is ``(B, Sq, H, Dh)``, k and v ``(B, Skv, KVH, Dh)`` with ``H % KVH == 0``;
query head h reads kv head ``h // (H // KVH)``.  Masking is by absolute
position: row i sits at ``i + q_offset`` and sees key j when j < Skv, j <= its
position if ``causal``, and its position minus j < ``sliding_window`` if one
is given.  The softmax runs in float32 and the output has q's dtype.

`flash_attention` launches the kernel for CUDA tensors and counts each launch
in ``flash_attention.launches``; for CPU tensors it runs the plain PyTorch
version `flash_attention_plain` (and counts nothing).  A CUDA tensor the
kernel does not take raises; nothing falls back.
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
    "flash_attention_fwd": [_P, _P, _P, _P, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                            ctypes.c_float, _P],
}


def flash_attention_plain(q, k, v, *, causal=True, sliding_window=None, q_offset=0):
    """The plain version (the reference's `ref.naive_attention`): the whole
    (Sq, Skv) score matrix in float32; a row with no allowed key gives 0."""
    B, Sq, H, Dh = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, Dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(Dh)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if sliding_window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < sliding_window
    p = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # rows with no allowed key
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, sliding_window=None, q_offset=0):
    """Attention of ``q`` over ``k``/``v`` (see the module docstring), one launch."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sliding_window=sliding_window,
                                     q_offset=q_offset)
    name = "flash_attention"
    dtype = _build.check_cuda_operands(name, dtypes=_build.ATTENTION_DTYPES, q=q, k=k, v=v)
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
    _build.check_aligned(name, q=q, k=k, v=v)
    out = torch.empty_like(q)
    fn = _build.load("flash_attention", _ARGTYPES).flash_attention_fwd
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(dtype == torch.bfloat16), B, Sq, Skv, H, KVH, Dh, int(q_offset), int(causal),
                int(sliding_window or 0), Dh**-0.5, _build.stream_of(q))
    _build.check_status(name, status)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
