"""Minibatch-client SVRP — params.

Port of `repro.core.minibatch`.  Each round samples b clients without
replacement; each solves its prox subproblem from the same variance-reduced
target and the server averages:

    S_k ~ Uniform([M], b);   y_k^m ~= prox_{eta f_m}(x_k - eta g_k^m)
    x_{k+1} = (1/b) sum_{m in S_k} y_k^m;   w_{k+1} = x_{k+1} w.p. p else w_k

Communication: 2b per round (+ 3pM expected anchor refresh).  The round body
is `rounds.ROUND_DEFS["svrp_minibatch"]`; the per-trial driver waits for the
sequential substrate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MinibatchParams(NamedTuple):
    """Per-trial hyperparameters, each a (B,) tensor in a sweep."""

    eta: torch.Tensor
    p: torch.Tensor
    smoothness: torch.Tensor  # per-client L, used only by the "gd" local solver
