"""Instance-batched solving: the torch Gram-form driver, the routed surface,
stacked single-problem solves, regularization paths and cross-validation."""
from .api import (
    batch_lipschitz,
    solve_batch,
    solve_gram_batch,
    solve_lasso_batch,
    stack_problems,
)
from .fista_gram import (
    BatchFISTAConfig,
    BatchResult,
    BatchState,
    GramBatch,
    fista_gram_batch,
    init_batch_state,
    make_gram_batch,
)
from .path import lasso_path, alpha_ladder, alpha_max_for, path_gram_batch
from .cv import cv_lasso, CVResult

__all__ = [
    "stack_problems",
    "solve_batch",
    "batch_lipschitz",
    "cv_lasso",
    "CVResult",
    "BatchFISTAConfig",
    "BatchResult",
    "BatchState",
    "GramBatch",
    "fista_gram_batch",
    "init_batch_state",
    "make_gram_batch",
    "solve_gram_batch",
    "solve_lasso_batch",
    "lasso_path",
    "alpha_ladder",
    "alpha_max_for",
    "path_gram_batch",
]
