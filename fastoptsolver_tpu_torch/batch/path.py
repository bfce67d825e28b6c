"""Regularization paths: one problem, a ladder of α₁ values, one batched
solve (port of ``fastoptsolver_tpu/batch/path.py``).

Each α on the ladder becomes one lane of a :class:`GramBatch` sharing the
problem's Gram, so the whole path solves in one certified batched call of
the torch driver (``fista_gram_batch``), as in the reference, which does not
route the path to a kernel either. ``warm_start=True`` runs the textbook
homotopy instead: αs descending, each solve started from the previous
solution.
"""
from __future__ import annotations

import numpy as np
import torch

from ..problems.base import as_tensor
from .fista_gram import (
    BatchFISTAConfig,
    BatchResult,
    GramBatch,
    fista_gram_batch,
    init_batch_state,
)


def alpha_ladder(alpha_max, n_alphas: int = 50, eps: float = 1e-3,
                 device=None) -> torch.Tensor:
    """Geometric ladder from α_max down to eps·α_max (sklearn's
    convention), float32, on ``device`` (default: the card; see
    ``problems.base.as_tensor``)."""
    return as_tensor(np.geomspace(float(alpha_max), float(alpha_max) * eps, n_alphas)
                     .astype(np.float32), torch.float32, device)


def alpha_max_for(c: torch.Tensor) -> torch.Tensor:
    """Smallest α₁ with an all-zero solution: ‖Aᵀb‖∞ (= ‖c‖∞ in Gram form)."""
    return torch.amax(torch.abs(c), dim=0)


def path_gram_batch(Q: torch.Tensor, c: torch.Tensor, btb: torch.Tensor,
                    L: torch.Tensor, alphas: torch.Tensor,
                    alpha2: float = 0.0) -> GramBatch:
    """Cross a single Gram-form problem with an α ladder: (n, n) Q →
    (n, n, K) batch sharing the data, one lane per α."""
    K = alphas.shape[0]
    tile = lambda x: x[..., None].expand(x.shape + (K,)).contiguous()
    return GramBatch(
        Q=tile(Q),
        c=tile(c),
        btb=btb.expand(K).contiguous(),
        alpha1=alphas.to(Q.dtype),
        alpha2=torch.full((K,), alpha2, dtype=Q.dtype, device=Q.device),
        L=(L + alpha2).expand(K).contiguous(),
    )


def lasso_path(
    problem,
    alphas=None,
    n_alphas: int = 50,
    eps: float = 1e-3,
    cfg: BatchFISTAConfig = BatchFISTAConfig(max_iter=2000, check_every=25),
    warm_start: bool = False,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, BatchResult]:
    """Solve the L1 path of a (dense or Gram form) least-squares problem on
    the problem's device. ``alphas`` (a tensor, numpy array or list) goes to
    that device; ``generator`` starts the power iteration (see
    ``ops.lipschitz``).

    Returns ``(alphas, BatchResult)`` with ``result.x`` of shape
    (n_alphas, n) ordered from α_max down.
    """
    from ..ops.lipschitz import estimate_lipschitz_gram

    gram = problem if hasattr(problem, "Q") else problem.to_gram()
    dev = gram.Q.device
    L = estimate_lipschitz_gram(gram.Q, generator)
    if alphas is None:
        amax = torch.amax(torch.abs(gram.c))
        alphas = alpha_ladder(float(amax), n_alphas, eps, device=dev)
    # descending, homotopy order
    alphas = torch.sort(as_tensor(alphas, gram.Q.dtype, dev), descending=True).values
    gb = path_gram_batch(gram.Q, gram.c, gram.btb, L, alphas, float(gram.alpha2))

    if not warm_start:
        return alphas, fista_gram_batch(gb, cfg)

    # sequential homotopy: each α warm-started from the previous solution
    n, K = gb.c.shape
    xs, gaps, iters, conv = [], [], [], []
    x_prev = gb.c.new_zeros((n,))
    for k in range(K):
        sl = slice(k, k + 1)
        sub = GramBatch(Q=gb.Q[:, :, sl], c=gb.c[:, sl], btb=gb.btb[sl],
                        alpha1=gb.alpha1[sl], alpha2=gb.alpha2[sl], L=gb.L[sl])
        st = init_batch_state(sub)._replace(X=x_prev[:, None], Y=x_prev[:, None])
        res = fista_gram_batch(sub, cfg, state0=st)
        x_prev = res.x[0]
        xs.append(res.x[0])
        gaps.append(res.rel_gap[0])
        iters.append(res.iters[0])
        conv.append(res.converged[0])
    result = BatchResult(
        x=torch.stack(xs),
        iters=torch.stack(iters),
        rel_gap=torch.stack(gaps),
        n_iters_total=torch.sum(torch.stack(iters)),
        converged=torch.stack(conv),
        failed=None,
    )
    return alphas, result
