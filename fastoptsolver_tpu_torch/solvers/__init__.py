"""Single-problem solvers (port of ``fastoptsolver_tpu.solvers``: all of it
but ``gram_dense``, the out-of-memory Gram solve)."""
from .common import Metrics, History, SolveResult, LineSearchConfig, ARMIJO_C
from .admm import ADMMConfig, ADMMResult, admm
from .cd import CDConfig, cd, certified_optimum
from .lbfgs import LBFGSConfig, lbfgs, lbfgs_with_history
from .owlqn import OWLQNConfig, owlqn, owlqn_with_history
from .svrg import SVRGConfig, prox_svrg
from .saga import SAGAConfig, prox_saga
from .genlasso import (
    GenLassoConfig,
    GenLassoResult,
    gen_lasso,
    fused_lasso,
    tv_denoise,
    trend_filter,
    difference_matrix,
)
from .ista import ISTAConfig, ista, ista_with_history
from .fista import (
    FISTAConfig,
    fista,
    fista_with_history,
    fista_delta_config,
    fista_step,
    FISTAState,
)

__all__ = [
    "ADMMConfig",
    "ADMMResult",
    "admm",
    "CDConfig",
    "cd",
    "certified_optimum",
    "LBFGSConfig",
    "lbfgs",
    "lbfgs_with_history",
    "OWLQNConfig",
    "owlqn",
    "owlqn_with_history",
    "SVRGConfig",
    "prox_svrg",
    "SAGAConfig",
    "prox_saga",
    "GenLassoConfig",
    "GenLassoResult",
    "gen_lasso",
    "fused_lasso",
    "tv_denoise",
    "trend_filter",
    "difference_matrix",
    "Metrics",
    "History",
    "SolveResult",
    "LineSearchConfig",
    "ARMIJO_C",
    "ISTAConfig",
    "ista",
    "ista_with_history",
    "FISTAConfig",
    "fista",
    "fista_with_history",
    "fista_delta_config",
    "fista_step",
    "FISTAState",
]
