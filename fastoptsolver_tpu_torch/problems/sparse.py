"""Sparse design matrices: the problem protocol over a sparse CSR ``A``
(port of ``fastoptsolver_tpu/problems/sparse.py``, which holds a BCOO).

For very sparse, very large design matrices a dense matvec spends its
bandwidth on zeros. :class:`SparseLeastSquares` keeps ``A`` as a torch
sparse CSR tensor, and every solver that takes the problem protocol runs on
it unchanged (ISTA, FISTA, FISTA-Δ, OWL-QN; ADMM and CD through
``to_gram``).

- **Aᵀ is its own CSR**, built once at construction. Both products of a
  gradient are then row-major sparse matvecs (cuSPARSE's SpMV on a CUDA
  tensor), where ``A.t()`` would be a CSC view whose product is a
  transposed SpMV: on the card that scatters every row's contributions with
  atomics. The price is a second copy of the values and indices.
- ``lipschitz`` power-iterates the operator AᵀA (``normal_matvec``, which
  ``ops.lipschitz.lipschitz_for`` also takes): A is never densified.
- ``to_gram`` forms AᵀA by a sparse-sparse product, then densifies the
  (n × n) Gram: the Gram-form solvers then never touch the sparse structure.
- ``torch.func.vmap`` takes no sparse tensor, so ``batch.solve_batch``
  refuses a stack of these (the reference never batches one either).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.lipschitz import _power_iteration, _start
from ..ops.prox import soft_threshold
from .base import as_tensor, fold_alphas, target_device
from .least_squares import GramLeastSquares


def _csr(A, dtype: torch.dtype, device) -> torch.Tensor:
    """``A`` (a dense tensor or array, a ``scipy.sparse`` matrix, or a torch
    sparse tensor) as a coalesced CSR tensor of ``dtype``."""
    if isinstance(A, torch.Tensor) and A.layout != torch.strided:
        dev = A.device if device is None else device
        A = A.to(dtype=dtype, device=dev)
        return A if A.layout == torch.sparse_csr else A.to_sparse_coo().coalesce().to_sparse_csr()
    if hasattr(A, "tocsr"):  # scipy.sparse
        csr = A.tocsr(copy=True)
        csr.sum_duplicates()
        dev = target_device(device)
        return torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(csr.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(csr.data), dtype=dtype, device=dev),
            size=csr.shape, check_invariants=False)
    return as_tensor(A, dtype, device).to_sparse_csr()


def _transpose(A: torch.Tensor) -> torch.Tensor:
    """Aᵀ of a CSR tensor as a CSR tensor of its own."""
    return A.to_sparse_coo().t().coalesce().to_sparse_csr()


@dataclasses.dataclass(frozen=True)
class SparseLeastSquares:
    """``g(x) = ½‖Ax−b‖² + ½α₂‖x‖²``, ``h = α₁‖x‖₁``, with CSR ``A`` and
    its transpose ``At`` (see the module note)."""

    A: torch.Tensor  # (m, n) sparse CSR
    At: torch.Tensor  # (n, m) sparse CSR
    b: torch.Tensor  # (m,)
    alpha1: torch.Tensor
    alpha2: torch.Tensor

    @classmethod
    def create(cls, A, b, reg_type: str = "lasso", alpha1: float = 0.0,
               alpha2: float = 0.0, dtype: torch.dtype = torch.float32,
               device=None) -> "SparseLeastSquares":
        """``A`` may be a dense tensor or array, a ``scipy.sparse`` matrix,
        or a torch sparse tensor (COO, CSR or CSC). A tensor keeps its device
        unless ``device`` names another; anything else goes to ``device`` or,
        when none is named, to the card."""
        a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
        A = _csr(A, dtype, device)
        return cls(A=A, At=_transpose(A), b=as_tensor(b, dtype, A.device),
                   alpha1=as_tensor(a1, dtype, A.device), alpha2=as_tensor(a2, dtype, A.device))

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def nnz(self) -> int:
        return self.A.values().numel()

    @property
    def density(self) -> float:
        return self.nnz / (self.A.shape[0] * self.A.shape[1])

    @property
    def ridge_in_smooth(self) -> bool:
        return True

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        return self.A @ x - self.b

    def normal_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """AᵀA·v, two sparse matvecs."""
        return self.At @ (self.A @ v)

    def smooth_value(self, x: torch.Tensor) -> torch.Tensor:
        r = self.residual(x)
        return 0.5 * (r @ r) + 0.5 * self.alpha2 * (x @ x)

    def smooth_grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.At @ self.residual(x) + self.alpha2 * x

    def smooth_value_and_grad(self, x: torch.Tensor):
        r = self.residual(x)
        return (0.5 * (r @ r) + 0.5 * self.alpha2 * (x @ x),
                self.At @ r + self.alpha2 * x)

    def prox(self, v: torch.Tensor, tau) -> torch.Tensor:
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x: torch.Tensor) -> torch.Tensor:
        return self.alpha1 * torch.sum(torch.abs(x))

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self) -> torch.Tensor:
        return self.b.new_zeros(self.dim)

    def lipschitz(self, generator: torch.Generator | None = None, n_iter: int = 100,
                  tol: float = 1e-6) -> torch.Tensor:
        """λ_max(AᵀA) + α₂ by operator power iteration from ``generator``'s
        start vector (by default one seeded with 0 on A's device)."""
        v0 = _start(self.dim, self.b, generator)
        return _power_iteration(self.normal_matvec, v0, n_iter, tol) + self.alpha2

    def to_gram(self) -> GramLeastSquares:
        """The Gram form, AᵀA by a sparse-sparse product, then dense."""
        return GramLeastSquares(Q=torch.sparse.mm(self.At, self.A).to_dense(),
                                c=self.At @ self.b, btb=self.b @ self.b,
                                alpha1=self.alpha1, alpha2=self.alpha2)
