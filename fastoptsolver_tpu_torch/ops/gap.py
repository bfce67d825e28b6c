"""Duality gap for L1/elastic-net regularized least squares (port of
``fastoptsolver_tpu/ops/gap.py``).

For ``f(x) = ½‖Ax−b‖² + ½α₂‖x‖² + α₁‖x‖₁``, with ``r = Ax − b`` and smooth
gradient ``u = Aᵀr + α₂x``, scaling ``s = min(1, α₁/‖u‖∞)`` makes
``(s·r, s·x)`` dual feasible and

    gap(x) = f(x) + ½‖s·r‖² + s·rᵀb + ½α₂‖s·x‖²    (α₂ ≥ 0)

bounds ``f(x) − f*``. In Gram form ``‖r‖² = xᵀQx − 2cᵀx + bᵀb`` and
``rᵀb = cᵀx − bᵀb``, so the certificate never needs A or b.
"""
from __future__ import annotations

import torch


def _gap_from_parts(rr, rb, xx, u_inf, uu, l1, alpha1, alpha2) -> torch.Tensor:
    """Common gap assembly from scalar (or per-lane) pieces: rr = ‖r‖²,
    rb = rᵀb, xx = ‖x‖², u = ∇g(x) (u_inf/uu its ∞-norm / sq-norm),
    l1 = ‖x‖₁."""
    alpha1 = torch.as_tensor(alpha1, dtype=rr.dtype, device=rr.device)
    alpha2 = torch.as_tensor(alpha2, dtype=rr.dtype, device=rr.device)
    f = 0.5 * rr + 0.5 * alpha2 * xx + alpha1 * l1
    # L1 dual-feasibility scaling of the residual certificate
    s = torch.where(u_inf > alpha1, alpha1 / torch.clamp_min(u_inf, 1e-38),
                    torch.ones_like(u_inf))
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * alpha2 * (s * s) * xx
    l1_gap = torch.clamp_min(f + dual_neg, 0.0)
    # smooth strongly-convex bound for α₁ = 0: f − f* ≤ ‖∇g‖²/(2·α₂); with
    # α₂ = 0 too, ‖∇g‖² is a stationarity measure only
    smooth_gap = uu / torch.where(alpha2 > 0, 2.0 * alpha2, torch.ones_like(alpha2))
    return torch.where(alpha1 > 0, l1_gap, smooth_gap)


def lasso_duality_gap(problem, x: torch.Tensor) -> torch.Tensor:
    """Suboptimality certificate ``≥ f(x) − f*`` for a (dense or Gram form)
    least-squares problem: the L1 duality gap for ``alpha1 > 0``; for
    ``alpha1 == 0, alpha2 > 0`` the strong-convexity bound ``‖∇g‖²/(2α₂)``;
    for a pure unregularized problem ``‖∇g‖²`` (stationarity only)."""
    a1, a2 = problem.alpha1, problem.alpha2
    if hasattr(problem, "Q"):
        Qx = problem.Q @ x
        rr = x @ Qx - 2.0 * (problem.c @ x) + problem.btb
        rb = problem.c @ x - problem.btb
        u = Qx - problem.c + a2 * x
    else:
        r = problem.A @ x - problem.b
        rr = r @ r
        rb = r @ problem.b
        u = problem.A.T @ r + a2 * x
    return _gap_from_parts(rr, rb, x @ x, torch.amax(torch.abs(u)), u @ u,
                           torch.sum(torch.abs(x)), a1, a2)


def relative_gap(problem, x: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """gap / max(f(x), floor), the 'relative gap' of the performance target."""
    return lasso_duality_gap(problem, x) / torch.clamp_min(problem.objective(x), floor)
