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


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


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


def config_from_jax(cfg) -> BatchFISTAConfig:
    """The port's ``BatchFISTAConfig`` with every field of the reference's
    frozen dataclass ``cfg``."""
    return BatchFISTAConfig(**dataclasses.asdict(cfg))
