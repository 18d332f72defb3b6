"""Kernel entry points the model code calls (the port of `repro.kernels.ops`).

The reference chooses between a chunked jnp path and its Pallas kernels with
a global `use_pallas` switch.  The port has no switch: the device decides.
A CUDA tensor goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version, inside each wrapper.

    attention(q, k, v, *, causal=True, sliding_window=None, q_offset=0)
        -> kernels.flash_attention.flash_attention  (K4)
    decode_attention(q, k_cache, v_cache, valid)
        -> kernels.decode_attention.decode_attention  (K5)

The model code looks both names up here at call time, so a caller that must
run the plain versions on the card (chip_smoke.py's replay) can rebind them.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention as attention

__all__ = ["attention", "decode_attention"]
