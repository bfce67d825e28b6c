"""Instance-batched lasso: the torch Gram-form driver and the routed surface."""
from .api import solve_lasso_batch
from .fista_gram import (
    BatchFISTAConfig,
    BatchResult,
    BatchState,
    GramBatch,
    fista_gram_batch,
    init_batch_state,
    make_gram_batch,
)

__all__ = [
    "BatchFISTAConfig",
    "BatchResult",
    "BatchState",
    "GramBatch",
    "fista_gram_batch",
    "init_batch_state",
    "make_gram_batch",
    "solve_lasso_batch",
]
