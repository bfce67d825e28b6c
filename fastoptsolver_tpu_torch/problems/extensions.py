"""Composite problem families beyond least squares (port of
``fastoptsolver_tpu/problems/extensions.py``).

Each is a frozen dataclass of tensors on one device over the problem
protocol (``problems.base``), so every prox-gradient solver runs on it
unchanged:

- :class:`NonNegativeLeastSquares`: ``h = indicator(x ≥ 0)``, optionally
  with L1 (and a ridge term in the smooth part);
- :class:`GroupLassoLeastSquares`: ``h = α_g Σ_g ‖x_g‖₂`` over contiguous
  equal-size groups;
- :class:`BoxConstrainedLeastSquares`: ``h = indicator(l ≤ x ≤ u)``;
- :class:`MultiTaskLeastSquares`: a matrix iterate with the L2,1 row penalty;
- :class:`QuantileRegression`, :class:`PoissonRegression`,
  :class:`HuberRegression`, :class:`WeightedLeastSquares`: other smooth
  losses under L1 (the first three and the weighted one carry a
  ``normal_matvec`` that ``ops.lipschitz.lipschitz_for`` power-iterates);
- :class:`SlopeLeastSquares` with :func:`slope_lambda_bh`: the sorted-L1
  penalty.

The ``create`` constructors take numpy arrays or tensors: a tensor keeps its
device, numpy goes to ``device`` or, when none is named, to the card
(``problems.base.as_tensor``); every other field follows ``A``'s device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.prox import (
    prox_box,
    prox_group_lasso,
    prox_nonneg,
    prox_slope,
    slope_norm,
    soft_threshold,
)
from .base import as_tensor, fold_alphas
from ..utils.pytree import register_dataclass


def _tensors(A, dtype, device, **fields):
    """``A`` by the device rule, then every other field on its device."""
    A = as_tensor(A, dtype, device)
    return dict(A=A, **{k: as_tensor(v, dtype, A.device) for k, v in fields.items()})


def _l1(problem, x: torch.Tensor) -> torch.Tensor:
    return problem.alpha1 * torch.sum(torch.abs(x))


@dataclasses.dataclass(frozen=True)
class _LSBase:
    A: torch.Tensor
    b: torch.Tensor

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        return self.A @ x - self.b

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        r = self.residual(x)
        return 0.5 * (r @ r)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.T @ self.residual(x)

    def smooth_value_and_grad(self, x: torch.Tensor):
        r = self.residual(x)
        return 0.5 * (r @ r), self.A.T @ r

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> torch.Tensor:
        return self.A.new_zeros(self.dim)


@register_dataclass
@dataclasses.dataclass(frozen=True)
class NonNegativeLeastSquares(_LSBase):
    """``min ½‖Ax−b‖² + ½α₂‖x‖² + α₁‖x‖₁  s.t. x ≥ 0`` (α₁ = α₂ = 0 gives
    plain NNLS; α₂ > 0 the positively-constrained elastic net, sklearn's
    ``ElasticNet(positive=True)``). The ridge term is in the smooth part."""

    alpha1: torch.Tensor = 0.0
    alpha2: torch.Tensor = 0.0

    @classmethod
    def create(cls, A, b, alpha1: float = 0.0, alpha2: float = 0.0,
               dtype: torch.dtype = torch.float32, device=None):
        return cls(**_tensors(A, dtype, device, b=b, alpha1=alpha1, alpha2=alpha2))

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        r = self.residual(x)
        return 0.5 * (r @ r) + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.T @ self.residual(x) + self.alpha2 * x

    def smooth_value_and_grad(self, x: torch.Tensor):
        r = self.residual(x)
        return (0.5 * (r @ r) + 0.5 * self.alpha2 * (x @ x),
                self.A.T @ r + self.alpha2 * x)

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        # prox of (L1 + nonneg indicator) = max(v − τα₁, 0)
        return prox_nonneg(v - tau * self.alpha1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        # the indicator is 0 on the feasible set, where every prox output lies
        return _l1(self, x)


@register_dataclass(static=("group_size",))
@dataclasses.dataclass(frozen=True)
class GroupLassoLeastSquares(_LSBase):
    """``min ½‖Ax−b‖² + α_g Σ_g ‖x_g‖₂`` over contiguous groups of
    ``group_size`` (a plain int, which a stacked solve keeps whole)."""

    alpha_g: torch.Tensor = 1.0
    group_size: int = 1

    @classmethod
    def create(cls, A, b, alpha_g: float, group_size: int,
               dtype: torch.dtype = torch.float32, device=None):
        fields = _tensors(A, dtype, device, b=b, alpha_g=alpha_g)
        if fields["A"].shape[-1] % group_size:
            raise ValueError(f"n={fields['A'].shape[-1]} not divisible by "
                             f"group_size={group_size}")
        return cls(group_size=int(group_size), **fields)

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(-1, self.group_size)

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return prox_group_lasso(self._grouped(v), tau * self.alpha_g, axis=-1).reshape(-1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha_g * torch.sum(torch.linalg.vector_norm(self._grouped(x), dim=-1))


@register_dataclass
@dataclasses.dataclass(frozen=True)
class BoxConstrainedLeastSquares(_LSBase):
    """``min ½‖Ax−b‖²  s.t. lower ≤ x ≤ upper`` (bounds scalar or (n,))."""

    lower: torch.Tensor = -1.0
    upper: torch.Tensor = 1.0

    @classmethod
    def create(cls, A, b, lower, upper, dtype: torch.dtype = torch.float32, device=None):
        return cls(**_tensors(A, dtype, device, b=b, lower=lower, upper=upper))

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return prox_box(v, lower=self.lower, upper=self.upper)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros(())

    def x0(self) -> torch.Tensor:
        return prox_box(self.A.new_zeros(self.dim), lower=self.lower, upper=self.upper)


@register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiTaskLeastSquares:
    """Multi-task (joint-sparsity) regression with a coefficient matrix
    X ∈ R^{n×T}: ``min ½‖AX−B‖_F² + ½α₂‖X‖_F² + α₁ Σ_j ‖X_{j,:}‖₂``, so the T
    tasks share one support. The prox-gradient solvers take the matrix
    iterate whole (their inner products and norms run over every axis of an
    iterate, ``solvers.common.vdot``/``vnorm``); L is λ_max(AᵀA) + α₂ as in
    the vector case."""

    A: torch.Tensor  # (m, n)
    B: torch.Tensor  # (m, T)
    alpha1: torch.Tensor  # row-group penalty weight
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, B, alpha1: float = 0.0, alpha2: float = 0.0,
               dtype: torch.dtype = torch.float32, device=None):
        fields = _tensors(A, dtype, device, B=B, alpha1=alpha1, alpha2=alpha2)
        if fields["B"].dim() != 2:
            raise ValueError(f"B must be (m, n_tasks), got shape {tuple(fields['B'].shape)}")
        return cls(**fields)

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def n_tasks(self) -> int:
        return self.B.shape[-1]

    @property
    def ridge_in_smooth(self) -> bool:
        return True

    def residual(self, X: torch.Tensor) -> torch.Tensor:
        return self.A @ X - self.B

    def smooth_value(self, X: torch.Tensor) -> torch.Tensor:
        R = self.residual(X)
        return 0.5 * torch.sum(R * R) + 0.5 * self.alpha2 * torch.sum(X * X)

    def smooth_grad(self, X: torch.Tensor) -> torch.Tensor:
        return self.A.T @ self.residual(X) + self.alpha2 * X

    def smooth_value_and_grad(self, X: torch.Tensor):
        R = self.residual(X)
        return (0.5 * torch.sum(R * R) + 0.5 * self.alpha2 * torch.sum(X * X),
                self.A.T @ R + self.alpha2 * X)

    def prox(self, V: torch.Tensor, tau) -> torch.Tensor:
        return prox_group_lasso(V, tau * self.alpha1, axis=-1)

    def nonsmooth_value(self, X: torch.Tensor) -> torch.Tensor:
        return self.alpha1 * torch.sum(torch.linalg.vector_norm(X, dim=-1))

    def objective(self, X: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(X) + self.nonsmooth_value(X)

    def x0(self) -> torch.Tensor:
        return self.A.new_zeros((self.dim, self.n_tasks))


@dataclasses.dataclass(frozen=True)
class _SmoothL1:
    """Shared plumbing of the losses below: ``g(x) = Σᵢ ℓ(uᵢ) + ½α₂‖x‖²``
    with u = ``_link(x)`` (the residual Ax − b unless a class says
    otherwise), ``∇g = Aᵀℓ′(u) + α₂x``; ``h = α₁‖x‖₁``; zeros to start.
    Each class gives ``_loss`` (Σᵢ ℓ(uᵢ)) and ``_psi`` (ℓ′)."""

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def ridge_in_smooth(self) -> bool:
        return True

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        return self.A @ x - self.b

    def _link(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual(x)

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return self._loss(self._link(x)) + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.T @ self._psi(self._link(x)) + self.alpha2 * x

    def smooth_value_and_grad(self, x: torch.Tensor):
        u = self._link(x)
        return (self._loss(u) + 0.5 * self.alpha2 * (x @ x),
                self.A.T @ self._psi(u) + self.alpha2 * x)

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return _l1(self, x)

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> torch.Tensor:
        return self.A.new_zeros(self.dim)


@register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantileRegression(_SmoothL1):
    """Smoothed quantile regression: ``g(x) = Σᵢ ρ_τ^μ(aᵢᵀx − bᵢ) + ½α₂‖x‖²``,
    ``h = α₁‖x‖₁``, with ρ_τ^μ the Moreau envelope (μ > 0) of the pinball
    loss ρ_τ(r) = max((1−τ)r, −τr) in the residual r = aᵀx − b:

        ρ_τ^μ(r) = r²/(2μ)              for −μτ ≤ r ≤ μ(1−τ)
                   (1−τ)r − μ(1−τ)²/2    for r >  μ(1−τ)
                   −τr − μτ²/2           for r < −μτ

    The gradient is ``Aᵀ clip(r/μ, −τ, 1−τ)`` with curvature ≤ 1/μ, so
    ``L = λ_max(AᵀA)/μ + α₂`` (``normal_matvec``)."""

    A: torch.Tensor
    b: torch.Tensor
    tau_q: torch.Tensor  # quantile level τ ∈ (0, 1)
    mu: torch.Tensor  # Moreau smoothing parameter > 0
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, b, tau: float = 0.5, mu: float = 0.1, alpha1: float = 0.0,
               alpha2: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        if not 0.0 < tau < 1.0:
            raise ValueError(f"quantile level tau must be in (0, 1), got {tau}")
        if mu <= 0.0:
            raise ValueError(f"smoothing mu must be > 0, got {mu}")
        return cls(**_tensors(A, dtype, device, b=b, tau_q=tau, mu=mu, alpha1=alpha1,
                              alpha2=alpha2))

    def normal_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Curvature-bound operator AᵀA/μ (ψ′ ≤ 1/μ on the quadratic branch)."""
        return self.A.T @ (self.A @ v) / self.mu

    def _loss(self, r: torch.Tensor) -> torch.Tensor:
        t, mu = self.tau_q, self.mu
        quad = r * r / (2.0 * mu)
        hi = (1.0 - t) * r - mu * (1.0 - t) ** 2 / 2.0
        lo = -t * r - mu * t * t / 2.0
        return torch.sum(torch.where(r > mu * (1.0 - t), hi,
                                     torch.where(r < -mu * t, lo, quad)))

    def _psi(self, r: torch.Tensor) -> torch.Tensor:
        return torch.clamp(r / self.mu, -self.tau_q, 1.0 - self.tau_q)

    def pinball_value(self, x: torch.Tensor) -> torch.Tensor:
        """The exact (unsmoothed) pinball objective, for reporting."""
        r = self.residual(x)
        return torch.sum(torch.maximum((1.0 - self.tau_q) * r, -self.tau_q * r))


@register_dataclass
@dataclasses.dataclass(frozen=True)
class PoissonRegression(_SmoothL1):
    """L1/L2-regularized Poisson regression (log-linear counts):
    ``g(x) = Σᵢ (exp(aᵢᵀx) − bᵢ·aᵢᵀx) + ½α₂‖x‖²``, ``h = α₁‖x‖₁``. The
    Hessian ``Aᵀdiag(exp(Ax))A`` is unbounded, so solve with
    ``backtracking=True``; ``normal_matvec`` gives the curvature at x₀ = 0
    (AᵀA) as the starting step's scale."""

    A: torch.Tensor
    b: torch.Tensor  # nonnegative counts
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, b, alpha1: float = 0.0, alpha2: float = 0.0,
               dtype: torch.dtype = torch.float32, device=None):
        return cls(**_tensors(A, dtype, device, b=b, alpha1=alpha1, alpha2=alpha2))

    def normal_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Curvature at the solver start x₀ = 0: Aᵀ diag(e⁰) A = AᵀA."""
        return self.A.T @ (self.A @ v)

    def _link(self, x: torch.Tensor) -> torch.Tensor:
        return self.A @ x

    def _loss(self, eta: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.exp(eta) - self.b * eta)

    def _psi(self, eta: torch.Tensor) -> torch.Tensor:
        return torch.exp(eta) - self.b


def slope_lambda_bh(n: int, q: float = 0.1, sigma: float = 1.0,
                    dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """Benjamini–Hochberg λ ladder for SLOPE, ``λ_i = σ·Φ⁻¹(1 − q·i/(2n))``,
    i = 1..n (non-increasing; Bogdan et al. 2015). ``dtype`` defaults to
    ``torch.get_default_dtype()``; the ladder goes to ``device`` by the
    device rule of ``problems.base.as_tensor``."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    i = as_tensor(np.arange(1, n + 1), dtype, device)
    return sigma * torch.special.ndtri(1.0 - q * i / (2.0 * n))


@register_dataclass
@dataclasses.dataclass(frozen=True)
class SlopeLeastSquares(_LSBase):
    """SLOPE / OWL regression: ``min ½‖Ax−b‖² + Σ_i λ_i |x|_(i)`` with a
    non-increasing, nonnegative ladder λ on the magnitudes in decreasing
    order (``ops.prox.prox_slope``). Equal λ recovers the lasso."""

    lam: torch.Tensor = None  # (n,)

    @classmethod
    def create(cls, A, b, lam, dtype: torch.dtype = torch.float32, device=None):
        fields = _tensors(A, dtype, device, b=b, lam=lam)
        lam = fields["lam"].expand(fields["A"].shape[-1]).contiguous()
        if bool((lam[1:] > lam[:-1]).any()) or bool((lam < 0).any()):
            raise ValueError("SLOPE lambda ladder must be non-increasing and >= 0")
        return cls(**dict(fields, lam=lam))

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return prox_slope(v, tau * self.lam)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return slope_norm(x, self.lam)


@register_dataclass
@dataclasses.dataclass(frozen=True)
class WeightedLeastSquares(_SmoothL1):
    """Per-row sample weights: ``g(x) = ½ Σᵢ wᵢ(aᵢᵀx − bᵢ)² + ½α₂‖x‖²``,
    ``h = α₁‖x‖₁`` (scaling rows by √wᵢ, kept explicit)."""

    A: torch.Tensor  # (m, n)
    b: torch.Tensor  # (m,)
    w: torch.Tensor  # (m,) nonnegative sample weights
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, b, w, reg_type: str = "lasso", alpha1: float = 0.0,
               alpha2: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
        return cls(**_tensors(A, dtype, device, b=b, w=w, alpha1=a1, alpha2=a2))

    def normal_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``Aᵀdiag(w)A·v``: the weighted normal operator, so the step size
        reflects the weights."""
        return self.A.T @ (self.w * (self.A @ v))

    def _loss(self, r: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(self.w * r * r)

    def _psi(self, r: torch.Tensor) -> torch.Tensor:
        return self.w * r

    def to_gram(self):
        """``Q = Aᵀdiag(w)A``: the weighted normal equations, on which the
        Gram-form solvers and the CD oracle run unchanged."""
        from .least_squares import GramLeastSquares

        Aw = self.A * self.w[:, None]
        return GramLeastSquares(Q=self.A.T @ Aw, c=Aw.T @ self.b,
                                btb=torch.sum(self.w * self.b * self.b),
                                alpha1=self.alpha1, alpha2=self.alpha2)


@register_dataclass
@dataclasses.dataclass(frozen=True)
class HuberRegression(_SmoothL1):
    """Robust regression: ``g(x) = Σᵢ huber_δ(aᵢᵀx − bᵢ) + ½α₂‖x‖²``,
    ``h = α₁‖x‖₁``, ``huber_δ(r) = ½r²`` for |r| ≤ δ and ``δ|r| − ½δ²``
    beyond; ψ′ ≤ 1, so ``L = λ_max(AᵀA) + α₂``."""

    A: torch.Tensor
    b: torch.Tensor
    delta: torch.Tensor
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, b, delta: float = 1.0, alpha1: float = 0.0, alpha2: float = 0.0,
               dtype: torch.dtype = torch.float32, device=None):
        return cls(**_tensors(A, dtype, device, b=b, delta=delta, alpha1=alpha1,
                              alpha2=alpha2))

    def _loss(self, r: torch.Tensor) -> torch.Tensor:
        a = torch.abs(r)
        return torch.sum(torch.where(a <= self.delta, 0.5 * r * r,
                                     self.delta * (a - 0.5 * self.delta)))

    def _psi(self, r: torch.Tensor) -> torch.Tensor:
        return torch.clamp(r, -self.delta, self.delta)
