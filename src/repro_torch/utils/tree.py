"""Parameter-tree helpers: the port of `repro.utils.tree`.

A tree is a nested dict whose leaves are tensors (the layout of the model
zoo's parameters).  Each helper maps leaf by leaf and returns a new tree of
the same structure; nothing is updated in place.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of ``tree`` (and the matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the order `tree_unflatten` puts them back."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in `tree_leaves` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda u, v: alpha * u + v, x, y)


def tree_dot(a, b):
    """The sum over leaves of ``vdot(x, y)``, each leaf's product in the
    leaf's own dtype, as the reference's `tree_dot`: its running sum starts
    from a weakly typed zero, so it runs in the dtype the leaves' products
    promote to (bfloat16 for an all-bf16 tree, float32 once a float32 leaf
    joins); an empty tree gives a float32 zero."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        v = torch.vdot(x.reshape(-1), y.reshape(-1))
        total = v if total is None else total + v
    return torch.zeros((), dtype=torch.float32) if total is None else total


def tree_sqnorm(a):
    return tree_dot(a, a)


def tree_norm(a):
    return torch.sqrt(tree_sqnorm(a))


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    """Bytes of every leaf: an int8 ``{"q", "s"}`` weight counts its int8
    values and its float32 scales."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_where(pred: bool, a, b):
    """``a`` where ``pred`` holds, else ``b``: the reference's `tree_where`
    with a host-side predicate (the refresh coin), so no leaf is copied."""
    return a if pred else b


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)`` with respect to every
    leaf of ``params`` (the reference's `jax.value_and_grad`).  The leaves
    are detached first, so ``params`` is never part of a graph; the loss is
    returned detached."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))
