"""Instance-batched lasso: the torch Gram-form driver, the routed surface,
regularization paths and cross-validation."""
from .api import solve_gram_batch, solve_lasso_batch
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
