"""Regularized least-squares problems, in dense and Gram form (port of
``fastoptsolver_tpu/problems/least_squares.py``).

``f(x) = ½||Ax−b||² + ½·α₂||x||² + α₁||x||₁`` with lasso / ridge /
elastic-net alpha folding, as immutable dataclasses of tensors on one device:

- :class:`LeastSquares` holds ``(A, b)``; the gradient costs two matvecs.
- :class:`GramLeastSquares` holds ``Q = AᵀA, c = Aᵀb, btb = bᵀb``; the
  gradient is ``Qx − c``.

Both fold the ridge term into the smooth part and use plain soft
thresholding as the prox, as the reference's solvers do. The ``create``
constructors take numpy arrays or tensors: a tensor keeps its device, numpy
goes to ``device`` or, when none is named, to the card
(``problems.base.as_tensor``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.prox import prox_elastic_net, soft_threshold
from .base import as_tensor, fold_alphas


@dataclasses.dataclass(frozen=True)
class LeastSquares:
    """``g(x) = ½||Ax−b||² + ½·α₂||x||²``, ``h(x) = α₁||x||₁``.

    With ``en_prox=True`` the ridge term moves into the nonsmooth part and
    the prox becomes the elastic-net prox: ``g = ½||Ax−b||²``,
    ``h = α₁||x||₁ + ½α₂||x||²``; both forms have the same minimizer."""

    A: torch.Tensor  # (m, n)
    b: torch.Tensor  # (m,)
    alpha1: torch.Tensor  # scalar (effective L1 weight; 0 disables prox/h)
    alpha2: torch.Tensor  # scalar (effective ridge weight)
    en_prox: bool = False

    @classmethod
    def create(cls, A, b, reg_type: str = "lasso", alpha1: float = 0.0,
               alpha2: float = 0.0, dtype: torch.dtype = torch.float32,
               en_prox: bool = False, device=None) -> "LeastSquares":
        a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
        A = as_tensor(A, dtype, device)
        return cls(A=A, b=as_tensor(b, dtype, A.device),
                   alpha1=as_tensor(a1, dtype, A.device),
                   alpha2=as_tensor(a2, dtype, A.device), en_prox=en_prox)

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def ridge_in_smooth(self) -> bool:
        """Whether α₂ contributes to the smooth part's Lipschitz constant."""
        return not self.en_prox

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        return self.A @ x - self.b

    def _smooth_a2(self):
        return 0.0 if self.en_prox else self.alpha2

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        r = self.residual(x)
        return 0.5 * (r @ r) + 0.5 * self._smooth_a2() * (x @ x)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.T @ self.residual(x) + self._smooth_a2() * x

    def smooth_value_and_grad(self, x: torch.Tensor):
        r = self.residual(x)
        val = 0.5 * (r @ r) + 0.5 * self._smooth_a2() * (x @ x)
        return val, self.A.T @ r + self._smooth_a2() * x

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        if self.en_prox:
            return prox_elastic_net(v, tau, self.alpha1, self.alpha2)
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        h = self.alpha1 * torch.sum(torch.abs(x))
        if self.en_prox:
            h = h + 0.5 * self.alpha2 * (x @ x)
        return h

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> torch.Tensor:
        """Reference starting point: zeros."""
        return self.A.new_zeros(self.dim)

    def to_gram(self) -> "GramLeastSquares":
        """Precompute the normal-equation form: one (n×m)@(m×n) matmul, in
        true f32 under the package's precision contract."""
        if self.en_prox:
            raise NotImplementedError(
                "Gram form folds the ridge term into the smooth part; use "
                "en_prox=False (same minimizer)"
            )
        return GramLeastSquares(Q=self.A.T @ self.A, c=self.A.T @ self.b,
                                btb=self.b @ self.b, alpha1=self.alpha1,
                                alpha2=self.alpha2)


@dataclasses.dataclass(frozen=True)
class GramLeastSquares:
    """Normal-equation form: ``g(x) = ½ xᵀQx − cᵀx + ½ btb + ½·α₂||x||²``."""

    Q: torch.Tensor  # (n, n) = AᵀA
    c: torch.Tensor  # (n,)   = Aᵀb
    btb: torch.Tensor  # scalar = bᵀb
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, b, reg_type: str = "lasso", alpha1: float = 0.0,
               alpha2: float = 0.0, dtype: torch.dtype = torch.float32,
               device=None) -> "GramLeastSquares":
        return LeastSquares.create(A, b, reg_type, alpha1, alpha2, dtype,
                                   device=device).to_gram()

    @property
    def dim(self) -> int:
        return self.Q.shape[-1]

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return (0.5 * (x @ (self.Q @ x)) - self.c @ x + 0.5 * self.btb
                + 0.5 * self.alpha2 * (x @ x))

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.Q @ x - self.c + self.alpha2 * x

    def smooth_value_and_grad(self, x: torch.Tensor):
        Qx = self.Q @ x
        val = (0.5 * (x @ Qx) - self.c @ x + 0.5 * self.btb
               + 0.5 * self.alpha2 * (x @ x))
        return val, Qx - self.c + self.alpha2 * x

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha1 * torch.sum(torch.abs(x))

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> torch.Tensor:
        return self.Q.new_zeros(self.dim)


@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    """Smooth L2-regularized logistic regression, labels in {−1, +1}:
    ``g(x) = Σᵢ log(1 + exp(−yᵢ·aᵢᵀx)) + ½·α₂||x||²``; optional L1 via prox."""

    A: torch.Tensor  # (m, n)
    y: torch.Tensor  # (m,) labels in {-1, +1}
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, y, alpha1: float = 0.0, alpha2: float = 0.0,
               dtype: torch.dtype = torch.float32, device=None) -> "LogisticRegression":
        A = as_tensor(A, dtype, device)
        return cls(A=A, y=as_tensor(y, dtype, A.device),
                   alpha1=as_tensor(alpha1, dtype, A.device),
                   alpha2=as_tensor(alpha2, dtype, A.device))

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    def _softplus(self, z: torch.Tensor) -> torch.Tensor:
        # log(1 + exp(z)) without torch's linear cut-off past z = 20, as
        # jax.nn.softplus computes it
        return torch.logaddexp(z, torch.zeros_like(z))

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        margins = self.y * (self.A @ x)
        return torch.sum(self._softplus(-margins)) + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        margins = self.y * (self.A @ x)
        w = -self.y * torch.sigmoid(-margins)
        return self.A.T @ w + self.alpha2 * x

    def smooth_value_and_grad(self, x: torch.Tensor):
        margins = self.y * (self.A @ x)
        val = torch.sum(self._softplus(-margins)) + 0.5 * self.alpha2 * (x @ x)
        w = -self.y * torch.sigmoid(-margins)
        return val, self.A.T @ w + self.alpha2 * x

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha1 * torch.sum(torch.abs(x))

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> torch.Tensor:
        return self.A.new_zeros(self.dim)
