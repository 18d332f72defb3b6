"""Federated language-model fine-tuning as a flat-vector problem.

Port of `repro.problems.fed_lm`.  The engine (`repro_torch.experiments`,
`repro_torch.core.rounds`) speaks one oracle dialect: ``grad(m, x)`` and
``full_grad(x)`` over a flat ``(d,)`` iterate.  `FedLMProblem` adapts the
model zoo to it, so DeepSVRP on a real model runs through the same
`run_batch` substrates, comm channels and bytes ledger as the synthetic
quadratics:

* the parameters travel as one flat vector in the order of the reference's
  `jax.flatten_util.ravel_pytree`, which sorts dict keys at every level
  (`ravel_params`; the model code reads its tree by key, so `unravel` gives
  back views of the vector);
* client m holds one fixed batch from the port's `data.SyntheticLMDataset`
  (Dirichlet topic mixtures: heterogeneous clients), stored client-major;
* there is no computable minimizer, so the problem reports ``metric(x)``,
  the mean LM loss over clients, which `RoundOps.dist_sq` puts in the
  engine's ``dist_sq`` column.

A gradient is taken with respect to the flat vector itself: one leaf
``x.detach().requires_grad_()``, the tree built as views of it, and
``torch.autograd.grad`` to that leaf.  Over lanes ``S + (d,)`` with ``m``
of shape ``S`` the rows are taken one at a time: each row has its own
parameters, and the kernels with a backward (on the card: K4 and K4b for
attention, K6 and K6b for the Mamba-2 scan, K7 and K7b for the WKV scan)
are `autograd.Function`s.  A forward without a gradient (``loss``,
``metric``) runs the forward kernels alone.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.device import full_precision_matmul, resolve_device
from repro_torch.models import model as M


# ------------------------------------------------------------------ ravel
def _sorted_leaves(tree, path=()):
    """``(path, leaf)`` pairs in `jax.tree_util` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _sorted_leaves(tree[k], path + (k,))]
    return [(path, tree)]


def param_layout(tree) -> tuple:
    """``((path, shape, dtype), ...)`` of a parameter tree, in ravel order."""
    return tuple((p, tuple(t.shape), t.dtype) for p, t in _sorted_leaves(tree))


def ravel_params(tree) -> torch.Tensor:
    """The tree's leaves flattened into one vector in `ravel_pytree`'s order,
    in the leaves' promoted dtype."""
    leaves = [t for _, t in _sorted_leaves(tree)]
    dtype = leaves[0].dtype
    for t in leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.reshape(-1).to(dtype) for t in leaves])


def unravel(x: torch.Tensor, layout: tuple):
    """The parameter tree of ``layout`` as views of the flat ``x`` (each leaf
    cast back to its own dtype where that differs from ``x``'s)."""
    sizes = [math.prod(shape) for _, shape, _ in layout]
    tree: dict = {}
    for (path, shape, dtype), piece in zip(layout, torch.split(x, sizes)):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = piece.view(shape)
        node[path[-1]] = leaf if leaf.dtype == dtype else leaf.to(dtype)
    return tree


# ---------------------------------------------------------------- problem
@dataclasses.dataclass(frozen=True, eq=False)
class FedLMProblem:
    """Federated LM fine-tune over M fixed heterogeneous client batches."""

    tokens: torch.Tensor  # (M, batch, seq) int64, client-major
    labels: torch.Tensor  # (M, batch, seq) int64
    cfg: ModelConfig
    layout: tuple  # `param_layout` of the model's tree, in ravel order
    num_params: int

    @property
    def num_clients(self) -> int:
        return self.tokens.shape[0]

    @property
    def dim(self) -> int:
        return self.num_params

    @property
    def device(self) -> torch.device:
        return self.tokens.device

    def unravel(self, x: torch.Tensor):
        return unravel(x, self.layout)

    # --- one client, one flat vector ----------------------------------------
    def _client_loss(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        idx = m.reshape(1)
        batch = {"tokens": self.tokens.index_select(0, idx)[0],
                 "labels": self.labels.index_select(0, idx)[0]}
        return M.loss_fn(self.unravel(x), self.cfg, batch)

    def _client_grad(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        leaf = x.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self._client_loss(leaf, m), leaf)
        return g

    # --- oracles (flat-vector dialect), batched over the shape of m ----------
    def loss(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        m = torch.as_tensor(m, device=self.device)
        out = torch.empty(m.shape, dtype=x.dtype, device=x.device)
        with torch.no_grad():
            for i in np.ndindex(*m.shape):
                out[i] = self._client_loss(x[i], m[i])
        return out

    def grad(self, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        m = torch.as_tensor(m, device=self.device)
        out = torch.empty(m.shape + (self.dim,), dtype=x.dtype, device=x.device)
        for i in np.ndindex(*m.shape):
            out[i] = self._client_grad(x[i], m[i])
        return out

    def full_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The mean gradient over clients, taken one client at a time so
        that one model gradient is alive at a time; per lane of ``x``."""
        out = torch.empty_like(x)
        clients = torch.arange(self.num_clients, device=self.device)
        for i in np.ndindex(*x.shape[:-1]):
            acc = torch.zeros_like(x[i])
            for m in clients:
                acc = acc + self._client_grad(x[i], m)
            out[i] = acc / self.num_clients
        return out

    def metric(self, x: torch.Tensor) -> torch.Tensor:
        """The mean LM loss over clients, per lane of ``x``: the engine's
        dist_sq column for a problem with no computable x_star."""
        out = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
        clients = torch.arange(self.num_clients, device=self.device)
        with torch.no_grad():
            for i in np.ndindex(*x.shape[:-1]):
                acc = torch.zeros((), dtype=x.dtype, device=x.device)
                for m in clients:
                    acc = acc + self._client_loss(x[i], m)
                out[i] = acc / self.num_clients
        return out

    def minimizer(self) -> torch.Tensor:
        raise ValueError(
            "FedLMProblem has no computable minimizer; pass x0=ravelled init "
            "params and x_star=x0 explicitly (x_star is unused — the problem "
            "reports metric(x), the across-client mean LM loss, as dist_sq)"
        )


def make_fed_lm_problem(cfg: ModelConfig, *, num_clients: int, per_client_batch: int,
                        seq_len: int, alpha: float = 0.3, seed: int = 0,
                        device=None) -> tuple[FedLMProblem, torch.Tensor]:
    """The problem and its flat initial vector on ``device`` (default CUDA):
    ``(problem, x0)`` with ``x0`` `models.init_params(cfg)` drawn from a
    `torch.Generator` seeded with ``seed``, ravelled in the reference's
    order, and client m's tokens ``SyntheticLMDataset(...).sample(m, ...)``
    (equal to the reference's for one seed).  Float32 products stay in
    float32 (no TF32).  Clients hold token rows only, so the audio and vlm
    families, whose losses also read frame or patch embeddings, are refused,
    as the reference's problem cannot run them either."""
    needs = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if needs:
        raise NotImplementedError(f"{cfg.name}: the federated LM's clients hold tokens only; "
                                  f"the {cfg.family} family also needs {needs}")
    dev = resolve_device(device)
    full_precision_matmul()
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, num_clients=num_clients,
                            alpha=alpha, seed=seed)
    toks = np.stack([ds.sample(m, per_client_batch, seq_len) for m in range(num_clients)])
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    x0 = ravel_params(params)
    problem = FedLMProblem(
        tokens=torch.as_tensor(toks[:, :, :-1], dtype=torch.int64, device=dev),
        labels=torch.as_tensor(toks[:, :, 1:], dtype=torch.int64, device=dev),
        cfg=cfg, layout=param_layout(params), num_params=int(x0.numel()),
    )
    return problem, x0
