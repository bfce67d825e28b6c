"""Problem definitions and generators (port of
``fastoptsolver_tpu.problems``; so far the protocol, the least-squares and
logistic problems, and the generators)."""
from .base import CustomProblem, fold_alphas, REG_TYPES
from .least_squares import LeastSquares, GramLeastSquares, LogisticRegression
from .generators import (
    X_TRUE,
    generate_boston_like,
    generate_scenario,
    generate_scenario_batch,
    generate_scenario_batch_fm,
    scenario_grid,
)

__all__ = [
    "CustomProblem",
    "fold_alphas",
    "REG_TYPES",
    "LeastSquares",
    "GramLeastSquares",
    "LogisticRegression",
    "generate_boston_like",
    "generate_scenario",
    "generate_scenario_batch",
    "generate_scenario_batch_fm",
    "scenario_grid",
    "X_TRUE",
]
