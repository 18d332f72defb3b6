"""PyTorch/CUDA port of `repro`, for one NVIDIA H100.

The JAX package `repro` stays the reference; this package grows beside it,
slice by slice, with every TPU kernel on a slice's path rewritten by hand for
Hopper.  It runs the paper's sweeps — SPPM, SVRP, minibatch SVRP, Catalyzed
SVRP and the baselines — on the federated quadratic and logistic problems
(`run_batch`: the fused path through the kernels, or by default the registry
path with any prox solver; `run_sequential` and the ``run_*`` drivers one
trial at a time); `repro_torch.launch` serves and trains the model zoo's
ported families.  A fused sweep:

    from repro_torch.experiments import run_batch
    from repro_torch.problems import make_synthetic_quadratic

    prob = make_synthetic_quadratic(num_clients=1000, dim=40, seed=0)
    res = run_batch("svrp", prob, grid={...}, seeds=8, fused=True,
                    num_steps=400, prox_solver="gd", prox_steps=40)

Entry points run on CUDA unless given ``device=``; with no card they raise.
Importing the package builds nothing and needs neither `nvcc` nor a card.
"""
from repro_torch.core.types import RunResult
from repro_torch.experiments import BatchResult, RunSpec, run_batch
from repro_torch.problems import (
    LogisticProblem,
    QuadraticProblem,
    make_a9a_like_problem,
    make_ridge_problem,
    make_synthetic_quadratic,
)

__all__ = [
    "BatchResult",
    "LogisticProblem",
    "QuadraticProblem",
    "RunResult",
    "RunSpec",
    "make_a9a_like_problem",
    "make_ridge_problem",
    "make_synthetic_quadratic",
    "run_batch",
]
