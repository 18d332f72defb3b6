"""Weight-only int8 quantization for serving: the port of `repro.quant.quant`.

Decode is memory-bound (weight streaming dominates), so int8 weights halve
the dominant term.  Symmetric per-output-channel int8:

    q = round(w / s),  s = max|w_col| / 127      (per output column)

Matmul weights (``w`` leaves) take one scale per output column, shared only
along the contraction axis (-2), so stacked ``(L, ...)`` and ``(G,
per_group, ...)`` leading axes keep their own scales; embeddings (``emb``)
one scale per row.  Only ``w`` / ``emb`` leaves with ``ndim >= 2`` and at
least ``1 << 14`` elements are quantized; norm scales, biases and other
small leaves stay as they are.  `models.layers.linear_apply` and
`embed_apply` take a ``{"q", "s"}`` leaf and dequantise it per call, one
layer's matrix at a time.

The scale is ``max(amax, 1e-12) / 127`` by TRUE division, as the reference's
`quantize_params` computes it eagerly (in `BatchServer.__init__`).  The
quant8 channel (`core.channel.quantize_int8`) follows the reference's
compiled rounds instead, where XLA folds the division into a product with
the float32 reciprocal of 127; the two rules differ in a few percent of the
scales, so neither reuses the other.  The division is by a tensor on the
weight's device: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves

PyTree = Any

_MIN_QUANT_SIZE = 1 << 14  # don't quantize tiny leaves


def _quantize_matrix(w: torch.Tensor, reduce_axis: int) -> dict:
    """Symmetric per-channel int8, the scale shared only along ``reduce_axis``.
    amax is taken in float32 from 0 (a zero-size axis gives amax 0), and the
    1e-12 floor keeps an all-zero channel at exact zeros instead of 0/0.

    A stacked leaf (``ndim > 2``, scales along -2) is quantized one slice of
    its first axis at a time, into int8 and float32 tensors allocated once:
    the same values (no scale spans two slices), with float32 temporaries the
    size of one slice, not of the stack (deepseek-moe-16b's routed experts
    are 19.9 GB a leaf in float32)."""
    if w.ndim > 2 and reduce_axis == -2 and w.shape[0] > 1:
        first = _quantize_matrix(w[0], reduce_axis)
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = first["s"].new_empty((w.shape[0], *first["s"].shape))
        q[0], s[0] = first["q"], first["s"]
        for i in range(1, w.shape[0]):
            part = _quantize_matrix(w[i], reduce_axis)
            q[i], s[i] = part["q"], part["s"]
        return {"q": q, "s": s}
    w32 = w.to(torch.float32)
    if w32.shape[reduce_axis] == 0:
        shape = list(w32.shape)
        shape[reduce_axis] = 1
        amax = torch.zeros(shape, dtype=torch.float32, device=w32.device)
    else:
        amax = w32.abs().amax(dim=reduce_axis, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / torch.tensor(127.0, device=w32.device)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_leaf(w: torch.Tensor, reduce_axis: int = -1) -> dict:
    """Quantize ONE tensor leaf to a ``{"q", "s"}`` dict (checked): any float
    tensor with ``ndim >= 1`` round-trips, zero-size ones and a single row
    or column along ``reduce_axis`` included; malformed input raises here."""
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"quantize_leaf expects an array leaf, got {type(w).__name__}")
    if w.ndim < 1:
        raise ValueError("quantize_leaf needs ndim >= 1 (a channel axis)")
    if not w.is_floating_point():
        raise TypeError(f"quantize_leaf expects a float array, got dtype {w.dtype}")
    return _quantize_matrix(w, reduce_axis=reduce_axis)


def quantize_named(name: str, leaf: torch.Tensor):
    """`quantize_params`' rule for one tensor leaf under key ``name``: a
    large 2D+ ``w`` / ``emb`` leaf as a ``{"q", "s"}`` dict, any other as it
    is.  A caller that cannot hold a float tree and its int8 form together
    replaces its leaves one at a time with this."""
    if name in ("w", "emb") and leaf.ndim >= 2 and leaf.numel() >= _MIN_QUANT_SIZE:
        # embeddings (V, D): a scale a row; matmuls (..., d_in, d_out): a scale a column
        return _quantize_matrix(leaf, reduce_axis=-1 if name == "emb" else -2)
    return leaf


def quantize_params(params: PyTree) -> PyTree:
    """Every large 2D+ ``w`` / ``emb`` leaf as a ``{"q", "s"}`` dict
    (`quantize_named`); the other leaves pass through BY DESIGN, but must be
    tensors: a malformed leaf (None, a python scalar) raises here, naming its
    path."""

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, names + [str(k)]) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"quantize_params: leaf at {'/'.join(names) or '<root>'} is "
                            f"{type(node).__name__}, expected an array")
        return quantize_named(names[-1], node) if names else node

    return visit(params, [])


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"}


def dequantize(leaf: dict, dtype=torch.float32) -> torch.Tensor:
    """The float tensor of one ``{"q", "s"}`` dict (checked): ``q s`` in
    float32, then cast to ``dtype``."""
    if not isinstance(leaf, dict) or not {"q", "s"} <= set(leaf):
        got = sorted(leaf) if isinstance(leaf, dict) else type(leaf).__name__
        raise TypeError(f"dequantize expects a {{'q', 's'}} dict from quantize_leaf, got {got}")
    return (leaf["q"].to(torch.float32) * leaf["s"]).to(dtype)


#: Leaf-level inverse under the reference's other name.
dequantize_leaf = dequantize


def dequantize_params(qparams: PyTree, dtype=torch.float32) -> PyTree:
    if _is_quantized(qparams):
        return dequantize(qparams, dtype)
    if isinstance(qparams, dict):
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    return qparams


def quantization_error(params: PyTree, qparams: PyTree) -> float:
    """Max relative per-leaf error of the quantized weights (sanity metric)."""
    errs = []
    for a, b in zip(tree_leaves(params), tree_leaves(dequantize_params(qparams))):
        if a.ndim >= 2 and a.numel() >= _MIN_QUANT_SIZE:
            a32 = a.to(torch.float32)
            num = (a32 - b).abs().max().item()
            den = a32.abs().max().item() + 1e-12
            errs.append(num / den)
    return max(errs) if errs else 0.0
