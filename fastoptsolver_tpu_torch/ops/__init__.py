"""Elementwise operators, objective, certificate and Lipschitz estimates
(port of ``fastoptsolver_tpu.ops``; ``df32`` is not ported: torch sets the
dtype per tensor and the card runs float64 natively)."""
from .prox import (
    soft_threshold,
    prox_l1,
    prox_elastic_net,
    prox_group_lasso,
    prox_nonneg,
    prox_box,
    prox_zero,
    prox_slope,
    slope_norm,
    isotonic_regression,
)
from .objective import compute_objective
from .lipschitz import (
    estimate_lipschitz,
    estimate_lipschitz_gram,
    lipschitz_for,
)
from .gap import lasso_duality_gap, relative_gap

__all__ = [
    "soft_threshold",
    "prox_l1",
    "prox_elastic_net",
    "prox_group_lasso",
    "prox_nonneg",
    "prox_box",
    "prox_zero",
    "prox_slope",
    "slope_norm",
    "isotonic_regression",
    "compute_objective",
    "estimate_lipschitz",
    "estimate_lipschitz_gram",
    "lipschitz_for",
    "lasso_duality_gap",
    "relative_gap",
]
