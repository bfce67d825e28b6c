"""Global-consensus ADMM over a row-sharded design matrix (port of
``fastoptsolver_tpu/parallel/admm.py``).

    minimize  Σᵢ ½‖Aᵢxᵢ − bᵢ‖² + ½(α₂/N)‖xᵢ‖²  +  h(z)
    subject to xᵢ = z,  i = 1..N ranks

Each rank owns a row block ``(Aᵢ, bᵢ)`` and a private ``xᵢ``; the
iteration (scaled dual, Boyd et al. 2011 §8.2) is

    xᵢ⁺ = (AᵢᵀAᵢ + (α₂/N)I + ρI)⁻¹ (Aᵢᵀbᵢ + ρ(z − uᵢ))
    z⁺  = prox_{h/(Nρ)}( meanᵢ(xᵢ⁺ + uᵢ) )          ← one all-reduce
    uᵢ⁺ = uᵢ + xᵢ⁺ − z⁺

The x-update goes through one ``eigh`` of the rank's own Gram block, so
adaptive ρ costs nothing. Per iteration: the all-reduce of an n-vector (the
consensus mean) and one all-reduce of the three squared norms of Boyd's
residuals (Σᵢ‖xᵢ−z‖², Σᵢ‖xᵢ‖², Σᵢ‖uᵢ‖², the reference's three ``psum``s
sent together). Every stop test reads replicated values, so every rank runs
the same number of steps. ``x_smooth`` and ``u`` come back stacked
``(N, n)`` on every rank, as the reference's global views are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.prox import soft_threshold
from ..problems.base import as_tensor, fold_alphas
from ..solvers.admm import ADMMConfig, ADMMResult, ADMMState
from ..solvers.common import run_loop
from .matvec import psum
from .mesh import MODEL_AXIS, axis_size


def gather_rows(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Each rank's ``t`` stacked along a new leading axis, on every rank."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def consensus_admm(A, b, mesh: DeviceMesh, reg_type: str = "lasso",
                   alpha1: float = 0.0, alpha2: float = 0.0,
                   config: ADMMConfig = ADMMConfig(), axis: str = MODEL_AXIS,
                   dtype: torch.dtype = torch.float32) -> ADMMResult:
    """Solve ``½‖Ax−b‖² + ½α₂‖x‖² + α₁‖x‖₁`` with A's rows split over
    ``mesh[axis]``. Every rank passes the global ``A``, ``b`` (numpy goes to
    the mesh's device type) and keeps its block; rows are zero-padded to a
    multiple of the axis size (zero rows change neither AᵀA nor Aᵀb)."""
    a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
    dev = None if isinstance(A, torch.Tensor) else mesh.device_type
    A = as_tensor(A, dtype, dev)
    b = as_tensor(b, dtype, A.device)
    m, n = A.shape
    n_dev = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    rows = -(-m // n_dev)
    lo = mesh.get_local_rank(axis) * rows
    A_blk = torch.zeros((rows, n), dtype=dtype, device=A.device)
    b_blk = torch.zeros((rows,), dtype=dtype, device=A.device)
    hi = min(lo + rows, m)
    if hi > lo:
        A_blk[: hi - lo] = A[lo:hi]
        b_blk[: hi - lo] = b[lo:hi]

    full = lambda v: torch.tensor(v, dtype=dtype, device=A.device)
    a1 = full(a1)
    gamma = config.over_relaxation
    sqrt_n, sqrt_N = torch.sqrt(full(float(n))), torch.sqrt(full(float(n_dev)))

    # the rank's own Gram block, diagonalised once
    Q = A_blk.T @ A_blk + (a2 / n_dev) * torch.eye(n, dtype=dtype, device=A.device)
    c = A_blk.T @ b_blk
    lam, V = torch.linalg.eigh(Q)

    def body(s: ADMMState) -> ADMMState:
        x = V @ ((V.T @ (c + s.rho * (s.z - s.u))) / (lam + s.rho))
        x_hat = gamma * x + (1.0 - gamma) * s.z
        zbar = psum(x_hat + s.u, group) / n_dev  # the consensus mean
        z = soft_threshold(zbar, a1 / (n_dev * s.rho))
        u = s.u + x_hat - z
        sq = psum(torch.stack([torch.sum((x - z) ** 2), torch.sum(x * x),
                               torch.sum(u * u)]), group)
        r_norm, x_norm, u_norm = torch.sqrt(sq)
        s_norm = s.rho * sqrt_N * torch.linalg.vector_norm(z - s.z)
        eps_pri = sqrt_n * sqrt_N * config.abstol + config.reltol * torch.maximum(
            x_norm, sqrt_N * torch.linalg.vector_norm(z))
        eps_dual = sqrt_n * sqrt_N * config.abstol + config.reltol * s.rho * u_norm
        converged = (r_norm <= eps_pri) & (s_norm <= eps_dual)
        rho, u_scaled = s.rho, u
        if config.adaptive_rho:
            grow = r_norm > config.rho_mu * s_norm
            shrink = s_norm > config.rho_mu * r_norm
            one = torch.ones_like(s.rho)
            factor = torch.where(grow, one * config.rho_tau,
                                 torch.where(shrink, one / config.rho_tau, one))
            rho_new = torch.clamp(s.rho * factor, 1.0 / config.rho_cap, config.rho_cap)
            u_scaled = u * (s.rho / rho_new)
            rho = rho_new
        return ADMMState(x=x, z=z, u=u_scaled, rho=rho, k=s.k + 1, r_norm=r_norm,
                         s_norm=s_norm, converged=converged)

    z0 = torch.zeros(n, dtype=dtype, device=A.device)
    inf = full(float("inf"))
    init = ADMMState(x=z0, z=z0, u=z0, rho=full(config.rho),
                     k=torch.zeros((), dtype=torch.int32, device=A.device),
                     r_norm=inf, s_norm=inf,
                     converged=torch.zeros((), dtype=torch.bool, device=A.device))
    final = run_loop(body, init, config.max_iter, lambda s: ~s.converged)
    return ADMMResult(x=final.z, x_smooth=gather_rows(final.x, group, n_dev),
                      u=gather_rows(final.u, group, n_dev), rho=final.rho,
                      n_iters=final.k, r_norm=final.r_norm, s_norm=final.s_norm,
                      converged=final.converged)
