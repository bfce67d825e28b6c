"""Generalized lasso: ADMM on ``½‖Ax − b‖² + ½α₂‖x‖² + α₁‖W·Dx‖₁`` (port of
``fastoptsolver_tpu/solvers/genlasso.py``).

A structured penalty ``‖Dx‖₁`` through a linear operator D covers:

- **fused lasso**            D = [first differences; identity]
- **1D total variation**     A = I, D = first differences (denoising)
- **ℓ1 trend filtering**     A = I, D = k-th order differences
- any user D (graph incidence matrices, wavelet frames, …)

Splitting ``z = Dx`` (Boyd et al., Distributed Optimization §6.4):

    x⁺ = (AᵀA + α₂I + ρDᵀD)⁻¹ (Aᵀb + ρDᵀ(z − u))
    ẑ  = γ·Dx⁺ + (1 − γ)·z                       # over-relaxation
    z⁺ = soft_threshold(ẑ + u, α₁·w/ρ)           # per-row weights w
    u⁺ = u + ẑ − z⁺

ρ is constant, so ``M = AᵀA + α₂I + ρDᵀD`` is fixed: one
``torch.linalg.eigh`` of M up front (its spectrum floored at
1e-7·max(λ_max, 1), so a singular M acts as a tiny ridge on its null space)
and every iteration is matmuls and a diagonal scale, in true f32 under the
package's precision contract. Boyd §3.3 stopping on the z = Dx splitting;
the host loop of ``solvers.common`` reads the flag every ``STOP_EVERY``
steps, every stopped problem frozen bit for bit. Stacked problems take a
leading batch axis on A, b and D (``torch.linalg.eigh`` batches), each
stopping on its own, as ``jax.vmap`` of the reference's loop does.

The reported solution is the quadratic-solve iterate ``x``; ``z`` carries
the exactly sparse transform ``≈ Dx``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.prox import soft_threshold
from ..problems.base import as_tensor
from .common import run_loop


@dataclasses.dataclass(frozen=True)
class GenLassoConfig:
    rho: float = 1.0
    max_iter: int = 2000
    abstol: float = 1e-7
    reltol: float = 1e-6
    over_relaxation: float = 1.6  # γ ∈ [1, 1.8]


class GenLassoState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor  # scaled dual
    k: torch.Tensor
    r_norm: torch.Tensor
    s_norm: torch.Tensor
    converged: torch.Tensor


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` over any leading (stacked) axes."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


class GenLassoResult(NamedTuple):
    x: torch.Tensor  # primal solution
    z: torch.Tensor  # ≈ Dx, exactly sparse where the penalty bites
    u: torch.Tensor
    n_iters: torch.Tensor
    r_norm: torch.Tensor
    s_norm: torch.Tensor
    converged: torch.Tensor

    def objective(self, A, b, D, alpha1, alpha2=0.0, weights=None):
        """``½‖Ax−b‖² + ½α₂‖x‖² + α₁·Σᵢ wᵢ|(Dx)ᵢ|`` on ``x``'s device and
        dtype. Pass the ``weights`` of the solve (:func:`fused_lasso` folds
        its two penalties into them with ``alpha1=1.0``)."""
        x = self.x
        t = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
        r = _mv(t(A), x) - t(b)
        pen = torch.abs(_mv(t(D), x))
        if weights is not None:
            pen = t(weights) * pen
        return (0.5 * torch.sum(r * r, -1) + 0.5 * alpha2 * torch.sum(x * x, -1)
                + alpha1 * torch.sum(pen, -1))


def difference_matrix(n: int, order: int = 1, dtype=np.float32) -> np.ndarray:
    """k-th order discrete difference operator, shape ``(n − order, n)``:
    order 1 rows are ``x[i+1] − x[i]`` (TV, fused lasso), order 2 the second
    difference (ℓ1 trend filtering); higher orders iterate."""
    if not 0 < order < n:
        raise ValueError(f"need 0 < order < n, got order={order}, n={n}")
    D = np.eye(n, dtype=np.float64)
    for _ in range(order):
        D = D[1:] - D[:-1]
    return D.astype(dtype)


def gen_lasso(A, b, D, alpha1: float = 1.0, alpha2: float = 0.0, weights=None,
              config: GenLassoConfig = GenLassoConfig(),
              dtype: torch.dtype = torch.float32, device=None) -> GenLassoResult:
    """Solve ``min_x ½‖Ax − b‖² + ½α₂‖x‖² + α₁·Σᵢ wᵢ|(Dx)ᵢ|``.

    ``weights`` (optional, ``(p,)``) scale the penalty per row of D. A, b
    and D may lead with a batch axis (stacked problems). A tensor ``A``
    keeps its device, numpy goes to ``device`` or, when none is named, to
    the card; b, D and the weights follow A."""
    A = as_tensor(A, dtype, device)
    b, D = as_tensor(b, dtype, A.device), as_tensor(D, dtype, A.device)
    w = (torch.ones(D.shape[-2], dtype=dtype, device=A.device) if weights is None
         else as_tensor(weights, dtype, A.device))
    return _solve(A, b, D, as_tensor(alpha1, dtype, A.device),
                  as_tensor(alpha2, dtype, A.device), w, config)


def _solve(A, b, D, alpha1, alpha2, w, config: GenLassoConfig) -> GenLassoResult:
    n, p = A.shape[-1], D.shape[-2]
    dtype, dev = A.dtype, A.device
    rho, gamma = config.rho, config.over_relaxation
    At, Dt = A.transpose(-1, -2), D.transpose(-1, -2)

    M = At @ A + alpha2 * torch.eye(n, dtype=dtype, device=dev) + rho * (Dt @ D)
    c = _mv(At, b)
    lam, V = torch.linalg.eigh(M)  # once; iterations are matmuls only
    lam = torch.maximum(lam, 1e-7 * torch.clamp_min(lam[..., -1:], 1.0))
    Vt = V.transpose(-1, -2)
    thresh = alpha1 * w / rho
    sqrt_p, sqrt_n = math.sqrt(p), math.sqrt(n)

    def step(s: GenLassoState) -> GenLassoState:
        x = _mv(V, _mv(Vt, c + rho * _mv(Dt, s.z - s.u)) / lam)
        Dx = _mv(D, x)
        z_hat = gamma * Dx + (1.0 - gamma) * s.z
        z = soft_threshold(z_hat + s.u, thresh)
        u = s.u + z_hat - z
        r_norm = _norm(Dx - z)
        s_norm = _norm(rho * _mv(Dt, z - s.z))
        eps_pri = sqrt_p * config.abstol + config.reltol * torch.maximum(_norm(Dx), _norm(z))
        eps_dual = sqrt_n * config.abstol + config.reltol * rho * _norm(_mv(Dt, u))
        done = (r_norm <= eps_pri) & (s_norm <= eps_dual)
        return GenLassoState(x, z, u, s.k + 1, r_norm, s_norm, done)

    lead = torch.broadcast_shapes(A.shape[:-2], D.shape[:-2], b.shape[:-1])
    zeros = lambda k: torch.zeros(lead + (k,), dtype=dtype, device=dev)
    inf = torch.full(lead, float("inf"), dtype=dtype, device=dev)
    state0 = GenLassoState(x=zeros(n), z=zeros(p), u=zeros(p),
                           k=torch.zeros(lead, dtype=torch.int32, device=dev),
                           r_norm=inf, s_norm=inf,
                           converged=torch.zeros(lead, dtype=torch.bool, device=dev))
    final = run_loop(step, state0, config.max_iter, lambda s: ~s.converged)
    return GenLassoResult(x=final.x, z=final.z, u=final.u, n_iters=final.k,
                          r_norm=final.r_norm, s_norm=final.s_norm, converged=final.converged)


def fused_lasso(A, b, alpha_fuse: float, alpha_sparse: float = 0.0,
                config: GenLassoConfig = GenLassoConfig(),
                dtype: torch.dtype = torch.float32, device=None) -> GenLassoResult:
    """Fused lasso: ``½‖Ax − b‖² + α_fuse·Σ|xᵢ₊₁ − xᵢ| + α_sparse·‖x‖₁``, both
    penalties in one solve by stacking ``D = [Δ₁; I]`` with per-row weights
    ``[α_fuse…, α_sparse…]``."""
    n = A.shape[-1]
    Delta = difference_matrix(n, 1, dtype=np.float64)
    if alpha_sparse > 0.0:
        D = np.vstack([Delta, np.eye(n)])
        w = np.concatenate([np.full(n - 1, alpha_fuse), np.full(n, alpha_sparse)])
    else:
        D, w = Delta, np.full(n - 1, alpha_fuse)
    return gen_lasso(A, b, D, alpha1=1.0, weights=w, config=config, dtype=dtype,
                     device=device)


def _denoise(y, lam: float, order: int, config: GenLassoConfig, dtype, device):
    y = as_tensor(y, dtype, device)
    n = y.shape[0]
    return gen_lasso(torch.eye(n, dtype=dtype, device=y.device), y,
                     difference_matrix(n, order, np.float64), alpha1=lam, config=config,
                     dtype=dtype)


def tv_denoise(y, lam: float, config: GenLassoConfig = GenLassoConfig(max_iter=5000),
               dtype: torch.dtype = torch.float32, device=None) -> GenLassoResult:
    """1D total-variation denoising: ``½‖x − y‖² + λ·Σ|xᵢ₊₁ − xᵢ|``."""
    return _denoise(y, lam, 1, config, dtype, device)


def trend_filter(y, lam: float, order: int = 2,
                 config: GenLassoConfig = GenLassoConfig(max_iter=5000),
                 dtype: torch.dtype = torch.float32, device=None) -> GenLassoResult:
    """ℓ1 trend filtering (Kim–Koh–Boyd–Gorinevsky): a piecewise polynomial
    of degree ``order − 1``, ``½‖x − y‖² + λ‖Δ^order x‖₁``."""
    return _denoise(y, lam, order, config, dtype, device)
