"""Problem definitions and generators (port of ``fastoptsolver_tpu.problems``),
the one-pass Gram reduction of an out-of-memory A (``streaming``) included.
``streaming.merge_grams``, the reference's merge of the hosts' partial Grams,
needs a process group and comes with the port of ``parallel/``."""
from .base import CustomProblem, fold_alphas, REG_TYPES
from .least_squares import LeastSquares, GramLeastSquares, LogisticRegression
from .sparse import SparseLeastSquares
from .boston import load_boston_csv, synthetic_boston
from .extensions import (
    HuberRegression,
    WeightedLeastSquares,
    NonNegativeLeastSquares,
    GroupLassoLeastSquares,
    BoxConstrainedLeastSquares,
    SlopeLeastSquares,
    slope_lambda_bh,
    QuantileRegression,
    PoissonRegression,
    MultiTaskLeastSquares,
)
from .streaming import DenseGram, stream_gram, chunk_rows, generator_chunks
from .generators import (
    X_TRUE,
    generate_boston_like,
    generate_scenario,
    generate_scenario_batch,
    generate_scenario_batch_fm,
    scenario_grid,
)

__all__ = [
    "DenseGram",
    "stream_gram",
    "chunk_rows",
    "generator_chunks",
    "SparseLeastSquares",
    "HuberRegression",
    "WeightedLeastSquares",
    "NonNegativeLeastSquares",
    "GroupLassoLeastSquares",
    "BoxConstrainedLeastSquares",
    "SlopeLeastSquares",
    "slope_lambda_bh",
    "QuantileRegression",
    "PoissonRegression",
    "MultiTaskLeastSquares",
    "load_boston_csv",
    "synthetic_boston",
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
