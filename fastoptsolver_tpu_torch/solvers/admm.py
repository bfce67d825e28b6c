"""ADMM for composite quadratic problems (port of
``fastoptsolver_tpu/solvers/admm.py``).

Alternating Direction Method of Multipliers on

    minimize  ½‖Ax − b‖² + ½·α₂‖x‖² + h(x)

split as ``g(x) + h(z)`` subject to ``x = z``, with ``h`` any prox-capable
nonsmooth term of the problem protocol:

    x⁺ = (Q + α₂I + ρI)⁻¹ (c + ρ(z − u))          # quadratic solve
    ẑ  = γ·x⁺ + (1−γ)·z                            # over-relaxation
    z⁺ = prox_{h/ρ}(ẑ + u)
    u⁺ = u + ẑ − z⁺

The x-update goes through one symmetric eigendecomposition ``Q + α₂I =
VΛVᵀ`` made once (``torch.linalg.eigh``), so every iteration is two n×n
matvecs and adaptive ρ (residual balancing) only changes the diagonal
``1/(λᵢ+ρ)``. Both run in true f32 under the package's precision contract.
Boyd §3.3 stopping; the loop reads its flag every ``STOP_EVERY`` steps.
The solution reported in ``x`` is the prox-feasible iterate ``z``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .common import norm, run_loop


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    rho: float = 1.0
    max_iter: int = 500
    abstol: float = 1e-7
    reltol: float = 1e-6
    over_relaxation: float = 1.0  # γ ∈ [1, 1.8]; 1.6 is a common accelerator
    adaptive_rho: bool = True
    rho_mu: float = 10.0  # residual-balancing trigger ratio
    rho_tau: float = 2.0  # ρ multiplier when triggered
    rho_cap: float = 1e6  # keep ρ in [1/cap, cap]


class ADMMState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor  # scaled dual
    rho: torch.Tensor
    k: torch.Tensor
    r_norm: torch.Tensor  # primal residual ‖x − z‖
    s_norm: torch.Tensor  # dual residual ρ‖z − z_prev‖
    converged: torch.Tensor


class ADMMResult(NamedTuple):
    x: torch.Tensor  # the prox-feasible iterate z (sparse/feasible)
    x_smooth: torch.Tensor  # the quadratic-solve iterate x
    u: torch.Tensor
    rho: torch.Tensor
    n_iters: torch.Tensor
    r_norm: torch.Tensor
    s_norm: torch.Tensor
    converged: torch.Tensor


def quadratic_data(problem):
    """``(Q_eff, c)`` with the smooth ridge term folded in, so that the smooth
    part is exactly ``½xᵀQ_eff x − cᵀx + const``. Accepts Gram-form problems
    (``Q, c``) and design-matrix problems (``A, b``); α₂ joins only where the
    problem keeps it in the smooth part (``ridge_in_smooth``)."""
    if hasattr(problem, "Q"):
        Q, c = problem.Q, problem.c
    elif hasattr(problem, "A"):
        Q = problem.A.T @ problem.A
        c = problem.A.T @ problem.b
    else:
        raise TypeError(
            "ADMM needs a quadratic smooth part: a problem exposing (Q, c) or (A, b)")
    a2 = getattr(problem, "alpha2", None)
    if a2 is not None and getattr(problem, "ridge_in_smooth", True):
        Q = Q + a2 * torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return Q, c


def admm(problem, config: ADMMConfig = ADMMConfig(), x0: torch.Tensor | None = None) -> ADMMResult:
    """Solve ``min ½xᵀQx − cᵀx + h(x)`` by ADMM, generic over the problem's
    ``prox`` (lasso, elastic-net, NNLS, box, group lasso)."""
    Q, c = quadratic_data(problem)
    n, dtype, dev = Q.shape[-1], Q.dtype, Q.device
    lam, V = torch.linalg.eigh(Q)  # once; every ρ afterwards is O(n²)

    def x_update(rhs, rho):
        return V @ ((V.T @ rhs) / (lam + rho))

    z0 = problem.x0() if x0 is None else torch.as_tensor(x0, dtype=dtype, device=dev)
    gamma = config.over_relaxation
    sqrt_n = torch.sqrt(torch.tensor(float(n), dtype=dtype, device=dev))

    def body(s: ADMMState) -> ADMMState:
        x = x_update(c + s.rho * (s.z - s.u), s.rho)
        x_hat = gamma * x + (1.0 - gamma) * s.z
        # problem.prox applies its own weights, so tau = 1/ρ gives prox_{h/ρ}
        z = problem.prox(x_hat + s.u, 1.0 / s.rho)
        u = s.u + x_hat - z
        r_norm = norm(x - z)
        s_norm = s.rho * norm(z - s.z)
        eps_pri = sqrt_n * config.abstol + config.reltol * torch.maximum(norm(x), norm(z))
        eps_dual = sqrt_n * config.abstol + config.reltol * s.rho * norm(u)
        converged = (r_norm <= eps_pri) & (s_norm <= eps_dual)
        rho, u_scaled = s.rho, u
        if config.adaptive_rho:
            grow = r_norm > config.rho_mu * s_norm
            shrink = s_norm > config.rho_mu * r_norm
            one = torch.ones_like(s.rho)
            factor = torch.where(grow, one * config.rho_tau,
                                 torch.where(shrink, one / config.rho_tau, one))
            rho_new = torch.clamp(s.rho * factor, 1.0 / config.rho_cap, config.rho_cap)
            u_scaled = u * (s.rho / rho_new)  # u is the scaled dual y/ρ
            rho = rho_new
        return ADMMState(x=x, z=z, u=u_scaled, rho=rho, k=s.k + 1, r_norm=r_norm,
                         s_norm=s_norm, converged=converged)

    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    init = ADMMState(x=z0, z=z0, u=torch.zeros(n, dtype=dtype, device=dev),
                     rho=torch.full((), config.rho, dtype=dtype, device=dev),
                     k=torch.zeros((), dtype=torch.int32, device=dev), r_norm=inf,
                     s_norm=inf, converged=torch.zeros((), dtype=torch.bool, device=dev))
    final = run_loop(body, init, config.max_iter, lambda s: ~s.converged)
    return ADMMResult(x=final.z, x_smooth=final.x, u=final.u, rho=final.rho,
                      n_iters=final.k, r_norm=final.r_norm, s_norm=final.s_norm,
                      converged=final.converged)
