"""The paper's federated problems: quadratics, a9a-like logistic regression,
their DP-ERM forms, and federated LM fine-tuning as a flat-vector problem."""
from repro_torch.problems.dp_erm import (
    DPLogisticProblem,
    DPQuadraticProblem,
    clip_rows,
    make_dp_a9a_problem,
    make_dp_logistic,
    make_dp_quadratic,
    privacy_spent,
    zcdp_to_eps,
)
from repro_torch.problems.fed_lm import FedLMProblem, make_fed_lm_problem
from repro_torch.problems.logistic import (
    LogisticProblem,
    ShiftedLogisticProblem,
    make_a9a_like_problem,
)
from repro_torch.problems.quadratic import (
    QuadraticProblem,
    make_ridge_problem,
    make_synthetic_quadratic,
)

__all__ = [
    "DPLogisticProblem",
    "DPQuadraticProblem",
    "FedLMProblem",
    "LogisticProblem",
    "QuadraticProblem",
    "ShiftedLogisticProblem",
    "clip_rows",
    "make_a9a_like_problem",
    "make_dp_a9a_problem",
    "make_dp_logistic",
    "make_dp_quadratic",
    "make_fed_lm_problem",
    "make_ridge_problem",
    "make_synthetic_quadratic",
    "privacy_spent",
    "zcdp_to_eps",
]
