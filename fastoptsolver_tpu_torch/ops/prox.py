"""Proximal operators (port of ``fastoptsolver_tpu/ops/prox.py``).

Elementwise torch functions on tensors of any device; the value and the
threshold may both be batched (they broadcast). The isotonic projection and
the SLOPE prox keep the reference's dense minimax form: no data-dependent
control flow, so a batch of coefficient vectors needs no host round trip.
"""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """L1 prox (soft thresholding): ``sign(v) * max(|v| - tau, 0)``.

    NaN propagates (``clamp_min`` keeps it), as ``jnp.maximum`` does, so the
    batched driver's non-finite quarantine still sees a diverged lane."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - tau, 0.0)


# Reference-compatible alias.
prox_l1 = soft_threshold


def prox_elastic_net(v: torch.Tensor, tau, alpha1, alpha2) -> torch.Tensor:
    """Prox of ``h(x) = alpha1*||x||_1 + 0.5*alpha2*||x||_2^2``:
    ``soft_threshold(v, tau*alpha1) / (1 + tau*alpha2)``."""
    return soft_threshold(v, tau * alpha1) / (1.0 + tau * alpha2)


def prox_group_lasso(v: torch.Tensor, tau, axis: int = -1,
                     eps: float = 1e-12) -> torch.Tensor:
    """Block soft thresholding: shrink each group (slice along ``axis``) by
    its L2 norm, ``v * max(1 - tau/||v||_2, 0)`` per group."""
    norms = torch.linalg.vector_norm(v, dim=axis, keepdim=True)
    return v * torch.clamp_min(1.0 - tau / torch.clamp_min(norms, eps), 0.0)


def prox_nonneg(v: torch.Tensor, tau=0.0) -> torch.Tensor:
    """Projection onto the non-negative orthant (prox of the indicator)."""
    del tau
    return torch.clamp_min(v, 0.0)


def prox_box(v: torch.Tensor, tau=0.0, lower=-1.0, upper=1.0) -> torch.Tensor:
    """Projection onto the box ``[lower, upper]`` (prox of the indicator);
    the bounds may be tensors."""
    del tau
    lower = torch.as_tensor(lower, dtype=v.dtype, device=v.device)
    upper = torch.as_tensor(upper, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lower), upper)


def prox_zero(v: torch.Tensor, tau=0.0) -> torch.Tensor:
    """Prox of ``h = 0`` (identity), for pure smooth problems (ridge)."""
    del tau
    return v


def isotonic_regression(w: torch.Tensor, increasing: bool = True) -> torch.Tensor:
    """Euclidean projection of ``w`` (1-D) onto the monotone cone, by the
    minimax characterization ``z_i = max_{j<=i} min_{k>=i} mean(w[j..k])``
    (non-decreasing) as dense O(n²) tensor ops: a prefix-sum outer
    difference, a cumulative max and a reversed cumulative min."""
    if not increasing:
        return -isotonic_regression(-w, increasing=True)
    n = w.shape[-1]
    P = torch.cat([w.new_zeros((1,)), torch.cumsum(w, dim=0)])  # (n+1,)
    j = torch.arange(n, device=w.device)[:, None]
    k = torch.arange(n, device=w.device)[None, :]
    length = (k + 1 - j).to(w.dtype)
    # mean(w[j..k]) for j <= k; the lower triangle masked to -inf so the
    # running max over j ignores it
    means = (P[k + 1] - P[j]) / torch.where(length > 0, length, torch.ones_like(length))
    means = torch.where(j <= k, means, torch.full_like(means, float("-inf")))
    C = torch.cummax(means, dim=0).values  # C[i, k] = max_{j<=i} mean(w[j..k])
    R = torch.flip(torch.cummin(torch.flip(C, dims=(1,)), dim=1).values, dims=(1,))
    return torch.diagonal(R)


def prox_slope(v: torch.Tensor, lam) -> torch.Tensor:
    """Prox of the sorted-L1 (SLOPE / OWL) norm ``Σ_i λ_i |x|_(i)``, λ
    non-increasing: sort ``|v|`` decreasing, subtract the ladder, project
    onto the non-increasing cone, clip at zero, undo the sort and signs
    (Bogdan et al. 2015, FastProxSL1). A scalar ``lam`` broadcasts to a
    constant ladder, recovering ``soft_threshold``."""
    lam = torch.as_tensor(lam, dtype=v.dtype, device=v.device).expand(v.shape)
    u = torch.abs(v)
    order = torch.argsort(-u, stable=True)
    z = torch.clamp_min(isotonic_regression(u[order] - lam, increasing=False), 0.0)
    inv = torch.argsort(order, stable=True)
    return torch.sign(v) * z[inv]


def slope_norm(x: torch.Tensor, lam) -> torch.Tensor:
    """The sorted-L1 norm value ``Σ_i λ_i |x|_(i)`` (λ non-increasing)."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device).expand(x.shape)
    return torch.sum(lam * torch.sort(torch.abs(x), descending=True).values)
