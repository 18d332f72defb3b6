"""The paper's algorithms (SPPM, SVRP, minibatch SVRP, Catalyzed SVRP, DeepSVRP) in PyTorch.

Port of `repro.core`: the round definitions and their fused substrate
(`rounds`), the prox-solver registry (`prox`), the identity comm channel
(`channel`), the injected random draws (`draws`), each algorithm's params
and theorem helpers, and DeepSVRP on parameter trees (`deep`, with
`rounds.local_prox_gd_tree`).
"""
from repro_torch.core.catalyst import (
    CatalyzedSVRPParams,
    catalyst_extrapolate,
    catalyst_inner_iterations,
    theorem3_gamma,
)
from repro_torch.core.deep import (
    DeepScaffoldState,
    DeepSVRPConfig,
    DeepSVRPState,
    FedAvgState,
    deep_scaffold_init,
    deep_scaffold_round,
    deep_svrp_init,
    deep_svrp_round,
    fedavg_round,
)
from repro_torch.core.draws import Draws, draw_schedule
from repro_torch.core.minibatch import MinibatchParams
from repro_torch.core.prox import (
    PROX_SOLVERS,
    ProxSolver,
    gd_steps_for_accuracy,
    get_prox_solver,
    prox_agd,
    prox_gd,
    prox_gd_batched,
    prox_newton,
    prox_newton_cg,
)
from repro_torch.core.rounds import (
    ROUND_DEFS,
    RoundDef,
    RoundOps,
    batched_scan,
    local_prox_gd_tree,
    scan_rounds,
)
from repro_torch.core.sppm import (
    SPPMParams,
    theorem1_iterations,
    theorem1_prox_accuracy,
    theorem1_stepsize,
)
from repro_torch.core.svrp import (
    SVRPParams,
    theorem2_iterations,
    theorem2_rate,
    theorem2_stepsize,
)
from repro_torch.core.types import RunResult

__all__ = [
    "CatalyzedSVRPParams",
    "DeepSVRPConfig",
    "DeepSVRPState",
    "DeepScaffoldState",
    "Draws",
    "FedAvgState",
    "MinibatchParams",
    "PROX_SOLVERS",
    "ProxSolver",
    "ROUND_DEFS",
    "RoundDef",
    "RoundOps",
    "RunResult",
    "SPPMParams",
    "SVRPParams",
    "batched_scan",
    "catalyst_extrapolate",
    "catalyst_inner_iterations",
    "deep_scaffold_init",
    "deep_scaffold_round",
    "deep_svrp_init",
    "deep_svrp_round",
    "draw_schedule",
    "fedavg_round",
    "gd_steps_for_accuracy",
    "get_prox_solver",
    "local_prox_gd_tree",
    "prox_agd",
    "prox_gd",
    "prox_gd_batched",
    "prox_newton",
    "prox_newton_cg",
    "scan_rounds",
    "theorem1_iterations",
    "theorem1_prox_accuracy",
    "theorem1_stepsize",
    "theorem2_iterations",
    "theorem2_rate",
    "theorem2_stepsize",
    "theorem3_gamma",
]
