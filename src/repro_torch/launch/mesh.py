"""1-D meshes of `torch.distributed` ranks for the engine's two shard modes.

Port of the part of `repro.launch.mesh` the experiment engine uses:
`make_sweep_mesh` (``run_batch(shard="data")``, the trial axis) and
`make_client_mesh` (``run_batch(shard="clients")`` and
``open_session(substrate="clients")``, the client axis).  Where the
reference lays an axis over a `jax.sharding.Mesh` of local devices and
shard_maps the round bodies over it, the port runs SPMD over the ranks of a
process group: every rank calls the entry point with the same arguments and
the same problem, and every rank returns the whole, replicated result.

The group is ``group=`` when the caller names one; else the initialised
default group (`torch.distributed.init_process_group`); else a world of
one, a private group on the backend of the run's device (NCCL for CUDA,
gloo for the CPU).  The world of one is made once per device and kept here;
it is never made the default group, so it changes nothing for other code in
the process.  A run in one process goes through the same collectives as a
run over many ranks: no branch skips them at size 1.

Every collective of both modes is `all_reduce` (a sum), as every collective
of the reference is a ``psum``.  On one GPU that matters: NCCL refuses two
ranks on one card, so a multi-rank world on one card runs over gloo, and
gloo reduces CUDA tensors with all_reduce but does not all_gather them.
`all_reduce` counts its calls in ``all_reduce.all_reduces``, as the kernel
wrappers count theirs in ``.launches``.

The production and debug meshes of the pod launch layer (ROADMAP §1 item
12) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

# Worlds of one by device, made at first use (see the module docstring).
_WORLDS_OF_ONE: dict[str, object] = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis over the ranks of a process group: this process's ``rank``
    of ``size``.  ``group`` is a `torch.distributed` process group (or a
    backend of one, for a world of one)."""

    axis: str  # "data" or "clients"
    group: object
    rank: int
    size: int

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self)


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, taken in place in ``t`` (in a
    contiguous copy where ``t`` is not contiguous), which it returns.  Every
    collective of both shard modes goes through here and is counted."""
    t = t.contiguous()
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    mesh.group.allreduce([t], opts).wait()
    all_reduce.all_reduces += 1
    return t


all_reduce.all_reduces = 0


def _world_of_one(device: torch.device):
    key = str(device)
    group = _WORLDS_OF_ONE.get(key)
    if group is None:
        store = dist.HashStore()
        if device.type == "cuda":
            group = dist.ProcessGroupNCCL(store, 0, 1, dist.ProcessGroupNCCL.Options())
        else:
            group = dist.ProcessGroupGloo(store, 0, 1, datetime.timedelta(minutes=30))
        _WORLDS_OF_ONE[key] = group
    return group


def _mesh(axis: str, group, device) -> Mesh:
    if group is None:
        if dist.is_initialized():
            group = dist.group.WORLD
        else:
            group = _world_of_one(torch.device("cuda" if device is None else device))
    return Mesh(axis, group, group.rank(), group.size())


def make_sweep_mesh(group=None, device=None) -> Mesh:
    """The ``("data",)`` axis of ``run_batch(shard="data")``: the trial axis
    over ``group``'s ranks (default: see the module docstring; ``device``
    picks the world of one's backend)."""
    return _mesh("data", group, device)


def make_client_mesh(group=None, device=None) -> Mesh:
    """The ``("clients",)`` axis of ``run_batch(shard="clients")`` and
    client-sharded sessions: the client axis over ``group``'s ranks, one
    contiguous block of clients a rank."""
    return _mesh("clients", group, device)
