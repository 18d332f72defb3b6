"""Carry state across from `repro`: numpy arrays in, the port's objects out.

The port never imports `repro`; what crosses between the two packages is
plain numpy.  `problem_from_arrays` rebuilds a `repro` problem from its
leaves (``A``/``b`` for a quadratic, ``Z``/``y``/``lam`` for a logistic
problem) and `hparams_from_numpy` a per-trial hparam table, so both packages
compute on the same data.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.experiments.spec import resolve_algo
from repro_torch.problems import LogisticProblem, QuadraticProblem


def problem_from_arrays(
    kind: str,
    arrays: Mapping[str, np.ndarray],
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float64,
):
    """The port's problem of ``kind`` ("quadratic" or "logistic") on the
    given leaves, as tensors of ``dtype`` on ``device`` (default CUDA)."""
    dev = resolve_device(device)

    def t(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=dev)

    if kind == "quadratic":
        return QuadraticProblem(A=t("A"), b=t("b"))
    if kind == "logistic":
        return LogisticProblem(Z=t("Z"), y=t("y"), lam=float(arrays["lam"]))
    raise ValueError(f"unknown problem kind {kind!r}; expected 'quadratic' or 'logistic'")


def hparams_from_numpy(algo: str, values: Mapping[str, np.ndarray], *, device=None):
    """``algo``'s params NamedTuple from a ``{field: (B,) array}`` table."""
    dev = resolve_device(device)
    params_cls = resolve_algo(algo).params_cls
    missing = set(params_cls._fields) - set(values)
    if missing:
        raise ValueError(f"{algo}: hparams need fields {sorted(missing)}")
    return params_cls(**{
        k: torch.tensor(np.asarray(values[k]), device=dev) for k in params_cls._fields
    })
