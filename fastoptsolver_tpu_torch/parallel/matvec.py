"""Distributed matvecs over a sharded design matrix (port of
``fastoptsolver_tpu/parallel/matvec.py``).

- **Row sharding** ``A ~ row_sharding``, x replicated. ``A @ x`` is local
  (each rank holds whole rows); ``Aᵀ y`` with row-sharded y is a local
  matvec and one all-reduce over the axis. The normal-equation gradient
  ``Aᵀ(Ax − b)`` costs one collective.
- **Column sharding** ``A ~ col_sharding``, x sharded. ``A @ x`` needs the
  all-reduce; ``Aᵀ r`` is local.

Each function is called by every rank with the global operands (a
``DTensor``, or the global value every rank holds, which each rank cuts to
its block) and returns a ``DTensor`` in the reference's output layout. Each
``psum`` of the reference is one ``dist.all_reduce`` (SUM) on the axis's
group; the ``*_local`` helpers are the per-rank bodies, which
``parallel.problem`` calls on its blocks directly.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .mesh import (
    MODEL_AXIS,
    col_sharding,
    local,
    place,
    replicated,
    row_sharding,
    vec_sharding,
)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The reference's ``lax.psum``: ``t`` summed over ``group``, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def row_value_and_grad_local(A_blk, b_blk, x, group):
    """(½‖Ax−b‖², Aᵀ(Ax−b)) from a row block: both sums in one all-reduce of
    the gradient with the value appended."""
    r = A_blk @ x - b_blk
    both = psum(torch.cat([A_blk.T @ r, (0.5 * (r @ r))[None]]), group)
    return both[-1], both[:-1]


def row_normal_grad_local(A_blk, b_blk, x, group):
    return psum(A_blk.T @ (A_blk @ x - b_blk), group)


def col_matvec_local(A_blk, x_blk, group):
    return psum(A_blk @ x_blk, group)


def _out(t, mesh, placements):
    return DTensor.from_local(t, mesh, placements, run_check=False)


def row_sharded_matvec(mesh: DeviceMesh, A, x, axis: str = MODEL_AXIS):
    """y = A @ x with A row-sharded, x replicated → y row-sharded. No comm."""
    A_blk = local(place(A, mesh, row_sharding(mesh, axis)))
    x_full = local(place(x, mesh, replicated(mesh)))
    return _out(A_blk @ x_full, mesh, vec_sharding(mesh, axis))


def row_sharded_rmatvec(mesh: DeviceMesh, A, y, axis: str = MODEL_AXIS):
    """z = Aᵀ @ y with A and y row-sharded → z replicated. One all-reduce."""
    A_blk = local(place(A, mesh, row_sharding(mesh, axis)))
    y_blk = local(place(y, mesh, vec_sharding(mesh, axis)))
    return _out(psum(A_blk.T @ y_blk, mesh.get_group(axis)), mesh, replicated(mesh))


def row_sharded_normal_grad(mesh: DeviceMesh, A, b, x, axis: str = MODEL_AXIS):
    """∇(½‖Ax−b‖²) = Aᵀ(Ax−b): local matvec, residual and adjoint, then a
    single all-reduce."""
    A_blk = local(place(A, mesh, row_sharding(mesh, axis)))
    b_blk = local(place(b, mesh, vec_sharding(mesh, axis)))
    x_full = local(place(x, mesh, replicated(mesh)))
    g = row_normal_grad_local(A_blk, b_blk, x_full, mesh.get_group(axis))
    return _out(g, mesh, replicated(mesh))


def row_sharded_value_and_grad(mesh: DeviceMesh, A, b, x, axis: str = MODEL_AXIS):
    """(½‖Ax−b‖², Aᵀ(Ax−b)), both reduced in one place: one all-reduce of
    the gradient and the value together."""
    A_blk = local(place(A, mesh, row_sharding(mesh, axis)))
    b_blk = local(place(b, mesh, vec_sharding(mesh, axis)))
    x_full = local(place(x, mesh, replicated(mesh)))
    val, g = row_value_and_grad_local(A_blk, b_blk, x_full, mesh.get_group(axis))
    return _out(val, mesh, replicated(mesh)), _out(g, mesh, replicated(mesh))


def col_sharded_matvec(mesh: DeviceMesh, A, x, axis: str = MODEL_AXIS):
    """y = A @ x with A column-sharded and x sharded → y replicated. One
    all-reduce."""
    A_blk = local(place(A, mesh, col_sharding(mesh, axis)))
    x_blk = local(place(x, mesh, vec_sharding(mesh, axis)))
    return _out(col_matvec_local(A_blk, x_blk, mesh.get_group(axis)), mesh,
                replicated(mesh))


def col_sharded_rmatvec(mesh: DeviceMesh, A, y, axis: str = MODEL_AXIS):
    """z = Aᵀ @ y with A column-sharded, y replicated → z sharded. No comm."""
    A_blk = local(place(A, mesh, col_sharding(mesh, axis)))
    y_full = local(place(y, mesh, replicated(mesh)))
    return _out(A_blk.T @ y_full, mesh, vec_sharding(mesh, axis))


def col_sharded_normal_grad(mesh: DeviceMesh, A, b, x, axis: str = MODEL_AXIS):
    """Aᵀ(Ax−b) with column sharding: one all-reduce for Ax, the adjoint
    local, the gradient sharded like x."""
    A_blk = local(place(A, mesh, col_sharding(mesh, axis)))
    b_full = local(place(b, mesh, replicated(mesh)))
    x_blk = local(place(x, mesh, vec_sharding(mesh, axis)))
    r = col_matvec_local(A_blk, x_blk, mesh.get_group(axis)) - b_full
    return _out(A_blk.T @ r, mesh, vec_sharding(mesh, axis))
