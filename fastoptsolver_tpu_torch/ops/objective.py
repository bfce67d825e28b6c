"""Standalone objective evaluation with reference-parity semantics (port of
``fastoptsolver_tpu/ops/objective.py``): the ridge term applies for reg_type
in {ridge, elasticnet}, the L1 term for {lasso, elasticnet}, unknown types
raise."""
from __future__ import annotations

import torch

from ..problems.base import fold_alphas


def compute_objective(x: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                      reg_type: str, alpha1: float, alpha2: float) -> torch.Tensor:
    """f(x) = ½||Ax−b||² (+ ½α₂||x||² if ridge/elasticnet) (+ α₁||x||₁ if
    lasso/elasticnet)."""
    a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
    r = A @ x - b
    return 0.5 * (r @ r) + 0.5 * a2 * (x @ x) + a1 * torch.sum(torch.abs(x))
