"""Hyperparameter grids for the batched experiment engine.

A *grid* is a mapping `name -> scalar or sequence`.  `expand_grid` takes the
cartesian product of all sequence-valued axes (scalars are broadcast), in
insertion order, and returns flat `(B,)` arrays — the trial axis that
`repro_torch.experiments.runner.run_batch` sweeps.

Example::

    expand_grid(eta=[1e-3, 1e-2], p=0.1)
    # {"eta": array([0.001, 0.01]), "p": array([0.1, 0.1])}

    expand_grid(eta=[1e-3, 1e-2], p=[0.05, 0.1, 0.2])["eta"].shape  # (6,)
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _as_axis(value) -> np.ndarray:
    arr = np.asarray(value)
    if arr.ndim > 1:
        raise ValueError(f"grid axis must be scalar or 1-D, got shape {arr.shape}")
    # Preserve integer axes exactly (client counts, inner-iteration budgets,
    # cohort sizes): a blanket float64 coercion silently corrupts values above
    # 2^53 and changes the dtype the scan drivers trace with.  Everything
    # non-integer keeps the old float64 behavior.
    if np.issubdtype(arr.dtype, np.integer):
        as64 = arr.astype(np.int64)
        # uint64 values above int64 max wrap NEGATIVE under the cast (the
        # int64<->uint64 round-trip is bijective, so compare signs, not bits).
        if np.issubdtype(arr.dtype, np.unsignedinteger) and bool((as64 < 0).any()):
            raise OverflowError(
                f"integer grid axis value exceeds int64 (dtype {arr.dtype}) "
                "— exactness cannot be preserved"
            )
        arr = as64
    else:
        arr = arr.astype(np.float64)
    return np.atleast_1d(arr)


def grid_size(axes: Mapping[str, object]) -> int:
    """Number of trials the cartesian product of `axes` produces."""
    size = 1
    for v in axes.values():
        size *= _as_axis(v).shape[0]
    return size


def expand_grid(**axes) -> dict[str, np.ndarray]:
    """Cartesian product of the given axes as flat (B,) arrays.

    Scalars participate as length-1 axes (pure broadcast).  The first-named
    axis varies slowest, matching ``np.meshgrid(indexing="ij")``.  Float axes
    expand as float64; integer axes stay int64 (exact).
    """
    if not axes:
        return {}
    names = list(axes)
    vals = [_as_axis(axes[k]) for k in names]
    mesh = np.meshgrid(*vals, indexing="ij")
    return {k: m.reshape(-1) for k, m in zip(names, mesh)}


def with_seeds(
    expanded: Mapping[str, np.ndarray], seeds: int | Sequence[int]
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Cross an expanded grid with a seed axis (seed-major trial order).

    Returns `(hparams, seed_per_trial)` where every hparam array and the seed
    array have length `num_seeds * B`: trial `s * B + j` runs hyperparameter
    combo `j` under seed `seeds[s]`.
    """
    seed_arr = np.arange(seeds) if isinstance(seeds, int) else np.asarray(list(seeds))
    if seed_arr.ndim != 1 or seed_arr.size == 0:
        raise ValueError("seeds must be a positive int or a non-empty 1-D sequence")
    # Seeds stay in the reference's uint32 range, so one seed names the same
    # trial in both packages.
    if seed_arr.min() < 0 or seed_arr.max() >= 2**32:
        raise ValueError("seeds must lie in [0, 2**32)")
    B = 1
    for v in expanded.values():
        B = v.shape[0]
        break
    tiled = {k: np.tile(v, seed_arr.size) for k, v in expanded.items()}
    return tiled, np.repeat(seed_arr, B)


def trial_labels(
    hparams: Mapping[str, np.ndarray], seeds: np.ndarray
) -> list[dict[str, float | int]]:
    """Per-trial `{name: value, "seed": s}` dicts for CSV/labeling.

    Values keep their axis dtype: integer axes label as python ints, float
    axes as python floats (see `_as_axis`).
    """
    out = []
    for i in range(seeds.shape[0]):
        row: dict[str, float | int] = {k: v[i].item() for k, v in hparams.items()}
        row["seed"] = int(seeds[i])
        out.append(row)
    return out
