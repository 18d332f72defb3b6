"""Comm channels: the client<->server wire as a pluggable layer.

Port of `repro.core.channel`, identity channel only.  Every transfer of a
round flows through the bound channel's ``down`` (server -> client iterate
broadcast, the one link that may carry state), ``up`` (client -> server) and
``bcast`` (anchor broadcast on a refresh event).  ``wire_nbytes(size,
itemsize)`` prices one payload as a static python int; the entry points
multiply it into the int64 bytes ledger.

The reference's lossy channels (quant8 with error feedback, cast, cast16)
are not ported yet; `get_channel` names them in a clear error.
"""
from __future__ import annotations


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


IDENTITY = CommChannel()

CHANNELS: dict[str, CommChannel] = {"identity": IDENTITY}

# The reference's channels that the port does not carry yet.
_NOT_PORTED = ("cast", "cast16", "quant8")


def get_channel(channel) -> CommChannel:
    """Resolve a channel spec (None / name / instance) to a `CommChannel`."""
    if channel is None:
        return IDENTITY
    if isinstance(channel, CommChannel):
        return channel
    if channel in _NOT_PORTED:
        raise ValueError(
            f"comm channel {channel!r} is not ported to repro_torch yet; "
            "only 'identity' (or None) runs here — use repro for lossy channels"
        )
    try:
        return CHANNELS[channel]
    except KeyError:
        raise ValueError(
            f"unknown comm channel {channel!r}: expected one of "
            f"{sorted([*CHANNELS, *_NOT_PORTED])} (or None for identity)"
        ) from None


def wire_vector_bytes(channel, size: int, itemsize: int = 4) -> int:
    """Static wire bytes for ONE d-vector payload under a channel."""
    return get_channel(channel).wire_nbytes(size, itemsize)
