"""Tree checkpoints in the reference's npz layout: the port of `repro.checkpoint`.

    save_checkpoint(directory, step, state._asdict())   # ckpt_{step:08d}.npz
    latest_step(directory)                              # the largest step saved, or None
    restore_checkpoint(directory, step, like)           # a tree shaped like ``like``

The layout is `repro.checkpoint.checkpoint`'s, so a file written by either
package restores in the other: one npz member a leaf, keyed by its path
parts joined by ``/`` (dict keys, NamedTuple field names, ``#i`` for a
list or tuple entry); a bfloat16 leaf stored as its ``uint16`` bits under
``key::bf16``; a Python int (the train states' ``step``) as a 0-d int32.
The write is atomic: a temporary file in the directory, then `os.replace`.

The port's one leaf the reference has no form for is a `torch.Generator`
(`SVRPServerState.rng`, the refresh coins of a native run): its
``get_state()`` bytes go under ``key::torch_generator`` and restore into a
new generator on the same device, so a resumed run draws the coins the
uninterrupted run would.  The reference's ``rng`` (threefry key words, or
``key::prngkey``) cannot seed a torch generator: restoring a file the
reference wrote leaves ``like``'s generator in the tree as it is.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

PyTree = Any
_SEP = "/"
_BF16_TAG = "::bf16"
_GEN_TAG = "::torch_generator"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """``[(path part, child)]`` of a tree node, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(f"#{i}", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, path: tuple = ()) -> dict[str, np.ndarray]:
    flat = {}
    kids = _children(tree)
    if kids is not None:
        for part, child in kids:
            flat.update(_flatten(child, path + (part,)))
        return flat
    if tree is None:  # an empty subtree, as in the reference
        return flat
    key = _SEP.join(path)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: keep the bits
            flat[key + _BF16_TAG] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    elif isinstance(tree, torch.Generator):
        flat[key + _GEN_TAG] = tree.get_state().numpy()
    elif isinstance(tree, int):
        flat[key] = np.asarray(tree, dtype=np.int32)
    else:
        raise TypeError(f"checkpoint: leaf {key or '<root>'} is {type(tree).__name__}, "
                        f"expected a tensor, a torch.Generator or an int")
    return flat


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Write ``tree`` to ``directory/ckpt_{step:08d}.npz`` atomically; returns the path."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def _rebuild(like, path: tuple, data, device):
    kids = _children(like)
    if kids is not None:
        values = [_rebuild(child, path + (part,), data, device) for part, child in kids]
        if isinstance(like, dict):
            return dict(zip(like.keys(), values))
        return type(like)(*values) if _is_namedtuple(like) else type(like)(values)
    if like is None:
        return None
    key = _SEP.join(path)
    if isinstance(like, torch.Generator):
        if key + _GEN_TAG not in data:  # the reference's key: it cannot seed a torch generator
            return like
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(data[key + _GEN_TAG]))
        return gen
    if key + _BF16_TAG in data:
        t = torch.from_numpy(data[key + _BF16_TAG].view(np.int16)).view(torch.bfloat16)
    elif key in data:
        t = torch.from_numpy(np.asarray(data[key]))
    else:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    if isinstance(like, int):
        return int(t)
    return t.to(device=device if device is not None else like.device, dtype=like.dtype)


def restore_checkpoint(directory: str, step: int, like: PyTree, device=None) -> PyTree:
    """The tree saved at ``step``, shaped like ``like``: each tensor in its
    ``like`` leaf's dtype, on ``device`` (default: that leaf's device); ints
    as ints; a generator as described in the module docstring."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        return _rebuild(like, (), data, device)
