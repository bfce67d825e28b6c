"""Carry values of the JAX package into the port, so that a test can feed
both packages identical inputs.

Everything arrives as numpy arrays (``np.asarray`` of a JAX array) or plain
Python values; this module imports no JAX. The JAX config dataclass is read
with ``dataclasses.asdict``, field by field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batch.fista_gram import BatchFISTAConfig, BatchState, GramBatch
from .kernels.fista_vmem import VmemSolveState
from .kernels.fused_solve import FusedSolveState
from .kernels.resident import ResidentSolveState


def _tensor(x) -> torch.Tensor:
    # C order: the port's twins sum in an order that follows the layout, so a
    # transposed numpy array would round differently from the same values
    # made on the port's side
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def gram_batch_from_numpy(Q, c, btb, alpha1, alpha2, L) -> GramBatch:
    """A CPU ``GramBatch`` from the reference's fields (Q (n, n, B),
    c (n, B), btb, alpha1, alpha2, L (B,)), dtypes kept."""
    return GramBatch(Q=_tensor(Q), c=_tensor(c), btb=_tensor(btb),
                     alpha1=_tensor(alpha1), alpha2=_tensor(alpha2),
                     L=_tensor(L))


def batch_state_from_numpy(X, Y, t, prev_step, done, iters, gap, k, tau,
                           first_step) -> BatchState:
    """A CPU driver ``BatchState`` from the reference's fields, in its
    field order (so ``batch_state_from_numpy(*jax_state)`` works)."""
    return BatchState(
        X=_tensor(X), Y=_tensor(Y), t=_tensor(t),
        prev_step=_tensor(prev_step), done=_tensor(np.asarray(done, bool)),
        iters=_tensor(np.asarray(iters, np.int32)), gap=_tensor(gap),
        k=int(np.asarray(k)), tau=_tensor(tau), first_step=_tensor(first_step),
    )


def vmem_state_from_numpy(X, Y, t, ps, tau, k, done, iters, gap) -> VmemSolveState:
    """A CPU ``VmemSolveState`` from the reference's fields, in its field
    order (``vmem_state_from_numpy(*jax_state)``), so that a checkpoint of
    the reference's burst engine resumes in the port."""
    return VmemSolveState(
        X=_tensor(X), Y=_tensor(Y), t=_tensor(t), ps=_tensor(ps),
        tau=_tensor(tau), k=torch.tensor(int(np.asarray(k)), dtype=torch.int32),
        done=_tensor(np.asarray(done, bool)),
        iters=_tensor(np.asarray(iters, np.int32)), gap=_tensor(gap),
    )


def _per_lane_state(cls, X, Y, t, ps, tau, k, done, iters, gap, n, B):
    """A per-lane-k engine's state (``cls``) from the reference's fields:
    ``k`` and ``iters`` int32, ``done`` bool, the rows ``(1, B)``; ``n``/``B``
    strip feature and lane padding."""
    rows = slice(None, n)
    lanes = slice(None, B)
    row = lambda v: _tensor(np.asarray(v).reshape(1, -1)[:, lanes])
    lane = lambda v, dt: _tensor(np.asarray(v, dt).reshape(-1)[lanes])
    return cls(
        X=_tensor(np.asarray(X)[rows, lanes]), Y=_tensor(np.asarray(Y)[rows, lanes]),
        t=row(t), ps=row(ps), tau=row(tau), k=lane(k, np.int32),
        done=lane(done, bool), iters=lane(iters, np.int32),
        gap=_tensor(np.asarray(gap).reshape(-1)[lanes]),
    )


def resident_state_from_numpy(X, Y, t, ps, tau, k, done, iters, gap,
                              n: int | None = None,
                              B: int | None = None) -> ResidentSolveState:
    """A CPU ``ResidentSolveState`` from the reference's fields, in its
    field order (``resident_state_from_numpy(*jax_state)``). ``n``/``B``
    strip the feature and lane padding of raw kernel outputs (the
    reference's returned state is already stripped)."""
    return _per_lane_state(ResidentSolveState, X, Y, t, ps, tau, k, done,
                           iters, gap, n, B)


def fused_state_from_numpy(X, Y, t, ps, tau, k, done, iters, gap) -> FusedSolveState:
    """A CPU ``FusedSolveState`` from the reference's fields, in its field
    order (``fused_state_from_numpy(*jax_state)``), so that a checkpoint of
    the reference's fused engine resumes in the port (under the ``b_tile``
    that cut it)."""
    return _per_lane_state(FusedSolveState, X, Y, t, ps, tau, k, done, iters,
                           gap, None, None)


def config_from_jax(cfg) -> BatchFISTAConfig:
    """The port's ``BatchFISTAConfig`` with every field of the reference's
    frozen dataclass ``cfg``."""
    return BatchFISTAConfig(**dataclasses.asdict(cfg))
