"""Problem-definition protocol (port of ``fastoptsolver_tpu/problems/base.py``).

Every problem is an immutable object exposing

  - ``smooth_value(x)``        g(x), the differentiable part
  - ``smooth_grad(x)``         ∇g(x)
  - ``smooth_value_and_grad(x)``  both, sharing the matvec
  - ``prox(v, tau)``           prox_{tau*h}(v) for the nonsmooth part h
  - ``nonsmooth_value(x)``     h(x)
  - ``objective(x)``           g(x) + h(x)
  - ``dim``                    number of optimization variables

Regularization folding (lasso / ridge / elasticnet → effective alphas) happens
once, at construction. The reference's problems are JAX pytrees; here they
are frozen dataclasses of tensors, all on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

# Regularization types accepted by the reference
# (objective_functions.py:17-28, lbfgs.py:11-35).
REG_TYPES = ("lasso", "ridge", "elasticnet")


def fold_alphas(
    reg_type: str, alpha1: float, alpha2: float, eps: float = 0.0
) -> tuple[float, float, str]:
    """Normalize ``(reg_type, alpha1, alpha2)`` into effective coefficients:
    lasso zeroes alpha2, ridge zeroes alpha1, elasticnet keeps both; unknown
    types raise ``ValueError``. With ``eps > 0`` this also applies the
    L-BFGS tiny-α reclassification: elastic-net with ``alpha1 < eps`` →
    ridge, ``alpha2 < eps`` → lasso.

    Returns ``(alpha1_eff, alpha2_eff, reg_type_eff)``.
    """
    if reg_type == "lasso":
        return alpha1, 0.0, "lasso"
    if reg_type == "ridge":
        return 0.0, alpha2, "ridge"
    if reg_type == "elasticnet":
        if eps > 0.0 and alpha1 < eps:
            return 0.0, alpha2, "ridge"
        if eps > 0.0 and alpha2 < eps:
            return alpha1, 0.0, "lasso"
        return alpha1, alpha2, "elasticnet"
    raise ValueError(f"Unsupported reg_type='{reg_type}'")


def as_tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or scalar) as a tensor of ``dtype``.

    A tensor keeps its device unless ``device`` names another. Anything else
    goes to ``device``, or, when none is named, to the current CUDA device:
    the port's entry points run on the card unless the caller asks for the
    CPU, so without a card this raises rather than carry on there."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=x.device if device is None else device)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=target_device(device))


def target_device(device=None) -> torch.device:
    """Where input that is not a tensor goes: ``device``, or, when none is
    named, the current CUDA device (raising without one)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for a numpy input; pass device='cpu' to run "
            "on the CPU, or hand in tensors on the device to use")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class CustomProblem:
    """Fully generic problem from user-supplied closures, the counterpart of
    the reference ISTA's injectable-callable API. Each callable takes
    ``x`` (and ``v, tau`` for the prox) and the entries of ``params`` as
    keyword arguments. Without ``smooth_grad_fn`` the gradient comes from
    ``torch.func.grad`` of ``smooth_value_fn``."""

    params: dict = dataclasses.field(default_factory=dict)
    smooth_value_fn: Callable = None
    smooth_grad_fn: Callable = None
    prox_fn: Callable = None
    nonsmooth_value_fn: Callable = None
    n_dim: int = 0

    @property
    def dim(self) -> int:
        return self.n_dim

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value_fn(x, **self.params)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        if self.smooth_grad_fn is None:
            return torch.func.grad(lambda z: self.smooth_value_fn(z, **self.params))(x)
        return self.smooth_grad_fn(x, **self.params)

    def smooth_value_and_grad(self, x: torch.Tensor):
        return self.smooth_value(x), self.smooth_grad(x)

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        if self.prox_fn is None:
            return v
        return self.prox_fn(v, tau, **self.params)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        if self.nonsmooth_value_fn is None:
            return x.new_zeros(())
        return self.nonsmooth_value_fn(x, **self.params)

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)
