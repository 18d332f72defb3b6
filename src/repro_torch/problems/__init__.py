"""The paper's federated problems: quadratics and a9a-like logistic regression."""
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
    "LogisticProblem",
    "QuadraticProblem",
    "ShiftedLogisticProblem",
    "make_a9a_like_problem",
    "make_ridge_problem",
    "make_synthetic_quadratic",
]
