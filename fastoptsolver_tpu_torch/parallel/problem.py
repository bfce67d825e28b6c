"""Sharded problem definitions (port of ``fastoptsolver_tpu/parallel/problem.py``):
distribution composes with the solvers.

:class:`DistributedLeastSquares` implements the problem protocol with the
all-reduced matvecs of ``parallel/matvec.py``, and the port's unmodified
``fista`` / ``ista`` / ``lbfgs`` loops run on top, called by every rank:

- ``layout="row"``: A's rows split over the axis, b with them; the iterate
  is a plain tensor that every rank holds whole. Each all-reduce gives every
  rank the same bits (the collective reduces each element once and hands
  the sum to all), so every rank takes the same stop and line-search
  decisions without another collective.
- ``layout="col"``: A's columns split, b replicated, the iterate a
  ``DTensor`` sharded like the columns. The solvers' reductions (``vdot``,
  ``vnorm``) on it are reductions over the whole iterate: DTensor reduces
  the ranks' partial sums, and a replicated value decides each stop.

The power iteration starts from the same vector on every rank: the same
``torch.Generator`` seed draws the whole start vector, and in the column
layout each rank keeps its slice (:meth:`DistributedLeastSquares.from_full`).

``shard_gram_batch`` covers the other axis: a ``GramBatch``'s instance axis
over the ``batch`` ranks (DTensors sharded on the trailing axis). The torch
driver runs on it unchanged; its "any lane live" test reduces over the
ranks, so every rank stops at the same block.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..batch.fista_gram import GramBatch
from ..ops.prox import soft_threshold
from ..problems.base import as_tensor, fold_alphas
from .matvec import col_matvec_local, psum, row_value_and_grad_local
from .mesh import (
    BATCH_AXIS,
    MODEL_AXIS,
    col_sharding,
    local,
    place,
    replicated,
    row_sharding,
    sharding,
    vec_sharding,
)


@dataclasses.dataclass(frozen=True)
class DistributedLeastSquares:
    """Row- or column-sharded ``½‖Ax−b‖² + ½α₂‖x‖² + α₁‖x‖₁``.

    layout="row": A ~ row_sharding, b ~ vec_sharding, x a plain tensor held
    whole by every rank; layout="col": A ~ col_sharding, b replicated, x a
    ``DTensor`` ~ vec_sharding."""

    A: DTensor
    b: DTensor
    alpha1: torch.Tensor
    alpha2: torch.Tensor
    mesh: DeviceMesh
    axis: str = MODEL_AXIS
    layout: str = "row"

    @classmethod
    def create(cls, A, b, mesh: DeviceMesh, reg_type: str = "lasso",
               alpha1: float = 0.0, alpha2: float = 0.0, axis: str = MODEL_AXIS,
               layout: str = "row", dtype: torch.dtype = torch.float32,
               ) -> "DistributedLeastSquares":
        """``A``, ``b``: the global arrays, which every rank passes (numpy
        goes to the mesh's device type), or DTensors."""
        if layout not in ("row", "col"):
            raise ValueError(f"layout must be 'row' or 'col', got {layout!r}")
        a1, a2, _ = fold_alphas(reg_type, alpha1, alpha2)
        dev = mesh.device_type
        conv = lambda t: (t.to(dtype) if isinstance(t, DTensor)
                          else as_tensor(t, dtype, None if isinstance(t, torch.Tensor) else dev))
        A, b = conv(A), conv(b)
        if layout == "row":
            A = place(A, mesh, row_sharding(mesh, axis))
            b = place(b, mesh, vec_sharding(mesh, axis))
        else:
            A = place(A, mesh, col_sharding(mesh, axis))
            b = place(b, mesh, replicated(mesh))
        scalar = lambda v: torch.tensor(v, dtype=dtype, device=A.device)
        return cls(A=A, b=b, alpha1=scalar(a1), alpha2=scalar(a2), mesh=mesh,
                   axis=axis, layout=layout)

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    @property
    def _group(self):
        return self.mesh.get_group(self.axis)

    def _vec(self, blk: torch.Tensor) -> DTensor:
        return DTensor.from_local(blk, self.mesh, vec_sharding(self.mesh, self.axis),
                                  run_check=False)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """A scalar sum over the whole iterate (all-reduced in the column
        layout)."""
        s = torch.sum(local(t))
        return psum(s, self._group) if self.layout == "col" else s

    # -- problem protocol ---------------------------------------------------

    def _residual_col(self, x) -> torch.Tensor:
        return col_matvec_local(self.A.to_local(), local(x), self._group) - self.b.to_local()

    def smooth_value_and_grad(self, x):
        a2 = self.alpha2
        if self.layout == "row":
            val, g = row_value_and_grad_local(self.A.to_local(), self.b.to_local(),
                                              local(x), self._group)
            return val + 0.5 * a2 * (x @ x), g + a2 * x
        r = self._residual_col(x)
        g = self._vec(self.A.to_local().T @ r + a2 * local(x))
        return 0.5 * (r @ r) + 0.5 * a2 * self._sum(local(x) * local(x)), g

    def smooth_grad(self, x):
        if self.layout == "row":
            return self.smooth_value_and_grad(x)[1]
        r = self._residual_col(x)
        return self._vec(self.A.to_local().T @ r + self.alpha2 * local(x))

    def smooth_value(self, x):
        return self.smooth_value_and_grad(x)[0]

    def prox(self, v, tau):
        return soft_threshold(v, tau * self.alpha1)

    def nonsmooth_value(self, x):
        return self.alpha1 * self._sum(torch.abs(local(x)))

    def objective(self, x):
        return self.smooth_value(x) + self.nonsmooth_value(x)

    def x0(self):
        n_loc = self.A.to_local().shape[-1]
        z = torch.zeros(n_loc, dtype=self.A.dtype, device=self.A.device)
        return self._vec(z) if self.layout == "col" else z

    def from_full(self, v: torch.Tensor):
        """A whole vector every rank holds, in the iterate's layout (the
        power iteration's start)."""
        if self.layout == "row":
            return v
        return place(v, self.mesh, vec_sharding(self.mesh, self.axis))

    def normal_matvec(self, v):
        """AᵀAv for the distributed power iteration (ops/lipschitz.py)."""
        A_blk = self.A.to_local()
        if self.layout == "row":
            return psum(A_blk.T @ (A_blk @ local(v)), self._group)
        return self._vec(A_blk.T @ col_matvec_local(A_blk, local(v), self._group))


def shard_gram_batch(gb: GramBatch, mesh: DeviceMesh, axis: str = BATCH_AXIS) -> GramBatch:
    """Lay a GramBatch's instance axis (the trailing axis of every leaf in
    the feature-major layout) across the mesh's ``axis``: each rank keeps
    its lanes of the batch every rank holds."""
    lay = lambda t: place(t, mesh, sharding(mesh, axis, t.dim() - 1))
    return GramBatch(Q=lay(gb.Q), c=lay(gb.c), btb=lay(gb.btb),
                     alpha1=lay(gb.alpha1), alpha2=lay(gb.alpha2), L=lay(gb.L))
