"""Batched multi-trial experiment engine (seeds x hyperparameter sweeps).

`run_batch(..., fused=True, prox_solver="gd")` runs a sweep of sppm, svrp,
svrp_minibatch or catalyzed_svrp as one hand-batched loop on the GPU;
`RunSpec` is the shared "what to run" record, resolved with the reference's
validation and error texts.
"""
from repro_torch.experiments.grid import expand_grid, grid_size, trial_labels, with_seeds
from repro_torch.experiments.runner import BatchResult, run_batch, run_sequential
from repro_torch.experiments.spec import ALGOS, AlgoSpec, RunSpec, as_runspec

__all__ = [
    "ALGOS",
    "AlgoSpec",
    "BatchResult",
    "RunSpec",
    "as_runspec",
    "expand_grid",
    "grid_size",
    "run_batch",
    "run_sequential",
    "trial_labels",
    "with_seeds",
]
