"""Comm channels: the client<->server wire as a pluggable layer.

Port of `repro.core.channel`.  Every transfer of a round flows through the
bound channel's ``down`` (server -> client iterate broadcast, the one link
that may carry state), ``up`` (client -> server) and ``bcast`` (anchor
broadcast on a refresh event).  Payloads carry the transferred vector along
the LAST axis; leading axes (trials, cohort clients) are compressed row by
row, so a lane batch reproduces the per-trial results bit for bit.

==========  =================================================================
channel     wire behavior
==========  =================================================================
identity    nothing: the payload passes unchanged, no state.  The default.
quant8      blockwise symmetric int8 (``QUANT_BLOCK`` values along the last
            axis share one float32 scale), the reference's
            `repro.quant.quantize_leaf` rule.  The broadcast link carries
            EF21 error feedback: the state is the residual ``e``, the wire
            carries ``Q(v + e)`` and the new residual is ``v + e - Q(v + e)``.
            The other two links quantize and dequantize, stateless.
cast        bf16 on the wire (a round-trip cast, stateless).
cast16      fp16 on the wire.
==========  =================================================================

``wire_nbytes(size, itemsize)`` prices one payload as a static python int:
``size * itemsize`` on identity, ``size * 2`` on the casts, and
``size + 4 * ceil(size / QUANT_BLOCK)`` on quant8 (0.254x of float32).
`payload_nbytes` sums it over a tree of tensors, meta tensors included, so a
model's transfer is priced without allocating the model.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.tree import tree_leaves

#: Block length of quant8's scales along the payload axis.
QUANT_BLOCK = 256


class CommChannel:
    """Identity channel — and the interface every channel implements."""

    name = "identity"
    stateful = False

    def wire_nbytes(self, size: int, itemsize: int = 4) -> int:
        return int(size) * int(itemsize)

    def init_state(self, payload):
        return ()

    def up(self, v):
        return v

    def bcast(self, v):
        return self.up(v)

    def down(self, state, v):
        return state, self.up(v)


class CastChannel(CommChannel):
    """Round-trip the payload through a narrower wire dtype (bf16 / fp16)."""

    def __init__(self, name: str, wire_dtype: torch.dtype):
        self.name = name
        self.wire_dtype = wire_dtype

    def wire_nbytes(self, size: int, itemsize: int = 4) -> int:
        return int(size) * self.wire_dtype.itemsize

    def up(self, v):
        return _narrow(v, self.wire_dtype).to(v.dtype)


def _narrow(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` rounded once to the nearest ``dtype`` value (ties to even).

    PyTorch converts float64 to a 16-bit type through float32, rounding
    twice: a float64 value just off a 16-bit midpoint can land on it in
    float32 and then round the wrong way.  The reference's conversion rounds
    once.  Rounding to float32 toward odd first (an inexact result keeps an
    odd last bit) makes the second rounding exact, as float32 keeps more
    than two bits beyond either 16-bit type."""
    if v.dtype != torch.float64:
        return v.to(dtype)
    v32 = v.to(torch.float32)
    back = v32.to(torch.float64)
    bits = v32.view(torch.int32)
    inexact = (back != v) & torch.isfinite(back) & ((bits & 1) == 0)
    toward_v = torch.where(v.abs() > back.abs(), bits + 1, bits - 1)
    return torch.where(inexact, toward_v, bits).view(torch.float32).to(dtype)


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along the last axis: ``(q, s)`` with ``s`` float32,
    the rule of `repro.quant.quant._quantize_matrix` (amax in float32, a
    1e-12 floor so a zero block quantizes to exact zeros, round half to
    even).  The scale is ``max(amax, 1e-12) / 127`` as the reference's
    compiled rounds take it: XLA folds the division by the constant into a
    product with its float32 reciprocal, and so does this, so that the round
    trip is the reference's bit for bit.  The serving weights' rule
    (`repro_torch.quant.quantize_params`) divides truly instead, as the
    reference's eager `quantize_params` does; the two differ in a few
    percent of the scales."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-12) * _INV_127
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, s


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * s).to(dtype)


def _blocks(a: torch.Tensor) -> torch.Tensor:
    """``a``'s last axis as ``(nb, QUANT_BLOCK)`` blocks, the last one padded with zeros."""
    d = a.shape[-1]
    nb = -(-d // QUANT_BLOCK)
    pad = nb * QUANT_BLOCK - d
    a_p = torch.nn.functional.pad(a, (0, pad)) if pad else a
    return a_p.reshape(a.shape[:-1] + (nb, QUANT_BLOCK))


def _unblock(blocks: torch.Tensor, d: int) -> torch.Tensor:
    """The inverse of `_blocks`: the padding cut off again."""
    return blocks.reshape(blocks.shape[:-2] + (-1,))[..., :d]


def roundtrip_block_int8(a: torch.Tensor) -> torch.Tensor:
    """Blockwise int8 quantize -> dequantize along the last axis of ``a``."""
    if a.shape[-1] == 0:
        return a
    return _unblock(dequantize_int8(*quantize_int8(_blocks(a)), a.dtype), a.shape[-1])


class Quant8Channel(CommChannel):
    """Blockwise symmetric int8 on the wire, error feedback on the broadcast link."""

    name = "quant8"
    stateful = True

    def wire_nbytes(self, size: int, itemsize: int = 4) -> int:
        size = int(size)
        return size + 4 * math.ceil(size / QUANT_BLOCK)

    def init_state(self, payload):
        return torch.zeros_like(payload)

    def up(self, v):
        return roundtrip_block_int8(v)

    def down(self, state, v):
        """Send ``Q(v + e)``, keep ``v + e - Q(v + e)``.  On a float32
        payload the reference's compiled residual is one fused multiply-add,
        ``v + e - q s`` rounded once, so it is taken in float64 here (where
        ``q s`` and the difference are exact) and rounded once to float32."""
        corrected = v + state
        if corrected.dtype != torch.float32 or corrected.shape[-1] == 0:
            sent = self.up(corrected)
            return corrected - sent, sent
        blocks = _blocks(corrected)
        q, s = quantize_int8(blocks)
        residual = blocks.double() - q.double() * s.double()
        d = corrected.shape[-1]
        return (_unblock(residual.float(), d),
                _unblock(dequantize_int8(q, s, torch.float32), d))


IDENTITY = CommChannel()

CHANNELS: dict[str, CommChannel] = {
    "identity": IDENTITY,
    "quant8": Quant8Channel(),
    "cast": CastChannel("cast", torch.bfloat16),
    "cast16": CastChannel("cast16", torch.float16),
}


def get_channel(channel) -> CommChannel:
    """Resolve a channel spec (None / name / instance) to a `CommChannel`."""
    if channel is None:
        return IDENTITY
    if isinstance(channel, CommChannel):
        return channel
    try:
        return CHANNELS[channel]
    except KeyError:
        raise ValueError(
            f"unknown comm channel {channel!r}: expected one of "
            f"{sorted(CHANNELS)} (or None for identity)"
        ) from None


def wire_vector_bytes(channel, size: int, itemsize: int = 4) -> int:
    """Static wire bytes for ONE d-vector payload under a channel."""
    return get_channel(channel).wire_nbytes(size, itemsize)


def payload_nbytes(channel, payload) -> int:
    """Static wire bytes for a tree (nested dicts) of tensors under a channel,
    from the leaves' shapes and dtypes alone: meta tensors price a model's
    transfer without allocating it."""
    ch = get_channel(channel)
    return sum(ch.wire_nbytes(math.prod(leaf.shape), leaf.dtype.itemsize)
               for leaf in tree_leaves(payload))
