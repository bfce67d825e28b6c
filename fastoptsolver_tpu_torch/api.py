"""One-call solving interface (port of ``fastoptsolver_tpu/api.py``).

``solve(A, b, "lasso", alpha1=0.5)`` builds the problem representation and
runs the chosen method:

- method: "fista" (default), "ista", "fista_delta", "lbfgs", "cd", "admm",
  "owlqn", "svrg", "saga";
- the Gram form is used when it pays (n ≤ 128 and m ≥ 4n, for every method
  but lbfgs, svrg and saga), so an iteration costs O(n²) instead of O(mn);
- extra keyword arguments go into the method's config dataclass (e.g.
  ``max_iter=…, backtracking=True, adaptive_restart=True, delta=4.0``);
  an unknown one raises ``TypeError``.

``A`` and ``b`` are tensors, which keep their device, or numpy arrays,
which go to ``device`` or, when none is named, to the card (raising without
one), as ``cv_lasso`` takes them. ``generator`` (a ``torch.Generator``)
stands where the reference takes a ``jax.random`` key: the power
iteration's start vector, and the row permutations of svrg and saga.
"""
from __future__ import annotations

import dataclasses

import torch

from .ops.lipschitz import estimate_lipschitz
from .problems import LeastSquares
from .solvers import (
    ADMMConfig,
    CDConfig,
    FISTAConfig,
    ISTAConfig,
    LBFGSConfig,
    OWLQNConfig,
    SAGAConfig,
    SVRGConfig,
    admm,
    cd,
    fista,
    fista_with_history,
    ista,
    ista_with_history,
    lbfgs,
    lbfgs_with_history,
    owlqn,
    owlqn_with_history,
    prox_saga,
    prox_svrg,
)

_METHODS = {
    "fista": (FISTAConfig, fista, fista_with_history),
    "fista_delta": (FISTAConfig, fista, fista_with_history),
    "ista": (ISTAConfig, ista, ista_with_history),
    "lbfgs": (LBFGSConfig, lbfgs, lbfgs_with_history),
    "cd": (CDConfig, cd, None),
    "admm": (ADMMConfig, admm, None),
    "owlqn": (OWLQNConfig, owlqn, owlqn_with_history),
    "svrg": (SVRGConfig, prox_svrg, None),
    "saga": (SAGAConfig, prox_saga, None),
}

# methods that need the rows (minibatch gathers) or run on (A, b) as the
# reference's L-BFGS does: never the Gram form
_ROW_METHODS = ("lbfgs", "svrg", "saga")


def uses_gram(method: str, m: int, n: int, gram: bool | None = None) -> bool:
    """Whether ``solve`` runs ``method`` on the Gram form at shape (m, n):
    by default when n ≤ 128 and m ≥ 4n (the setup's O(mn²) is amortized by
    O(n²) iterations); never for lbfgs, svrg and saga."""
    if method in _ROW_METHODS:
        return False
    return (n <= 128 and m >= 4 * n) if gram is None else bool(gram)


def solve(A, b, reg_type: str = "lasso", alpha1: float = 0.0, alpha2: float = 0.0,
          method: str = "fista", history: bool = False, gram: bool | None = None,
          dtype: torch.dtype = torch.float32, x0=None,
          generator: torch.Generator | None = None, device=None, **config_kwargs):
    """Solve ``min ½‖Ax−b‖² + reg`` with the chosen method. See the module note."""
    if method not in _METHODS:
        raise ValueError(f"Unknown method '{method}' (one of {sorted(_METHODS)})")
    cfg_cls, run, run_hist = _METHODS[method]
    if method == "fista_delta":
        config_kwargs.setdefault("momentum", "delta")
        config_kwargs.setdefault("delta", 3.0)

    problem = LeastSquares.create(A, b, reg_type, alpha1, alpha2, dtype=dtype, device=device)
    m, n = problem.A.shape
    if uses_gram(method, m, n, gram):
        problem = problem.to_gram()

    valid = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = set(config_kwargs) - valid
    if unknown:
        raise TypeError(f"{method} does not accept config options {sorted(unknown)}")
    config = cfg_cls(**config_kwargs)

    if history:
        if run_hist is None:
            raise ValueError(f"method '{method}' has no history variant")
        if method in ("lbfgs", "owlqn"):
            return run_hist(problem, config, x0=x0)
        return run_hist(problem, config, x0=x0, generator=generator)
    if method == "svrg":
        L = estimate_lipschitz(problem.A) + problem.alpha2
        return run(problem, L, config, x0=x0, generator=generator)
    if method in ("lbfgs", "cd", "admm", "owlqn"):
        return run(problem, config, x0=x0)
    return run(problem, config, x0=x0, generator=generator)
