"""K-fold cross-validated lasso: the whole CV grid in one routed batched solve
(port of ``fastoptsolver_tpu/batch/cv.py``).

The (folds × α-ladder) grid plus the full-data refit path is one
:class:`GramBatch` of ``(k_folds + 1)·K`` lanes, solved by
``solve_gram_batch``: on a CUDA tensor the burst kernel
(``csrc/fista_burst.cu``, one launch per burst) at n ≤ 104 and the resident
kernel (``csrc/resident.cu``, one launch) at 104 < n ≤ 168, as the router
picks; on a CPU tensor the torch driver.

- **Gram subtraction**: fold j's training Gram is ``AᵀA − A_jᵀA_j`` (and
  likewise for ``c``, ``bᵀb``): one full Gram plus one batched fold-Gram
  einsum. These contractions run outside any kernel, as in the reference,
  in true f32 under the package's precision contract.
- Folds follow sklearn's KFold: contiguous blocks with the m mod k remainder
  spread one row each over the first folds, gathered against a sentinel
  zero row so that ragged folds share one shape.
- **Per-fold penalty scaling**: a fold fit over m − |fold j| rows carries
  (m − |fold j|)/m of the full-data penalty (sklearn's per-sample
  objective); the refit keeps full scale.
- Validation MSE is two einsums; the optional one-standard-error rule picks
  the largest α within one SE of the minimum.

Differences from the reference: ``generator`` (a ``torch.Generator``)
shuffles the rows where the reference takes a ``jax.random`` key, so a seed
gives another permutation than the reference's; the Lipschitz estimates
start from the port's own vector (``ops.lipschitz``); the steps run eagerly,
with no compiled program per shape.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lipschitz import estimate_lipschitz_gram
from ..problems.base import as_tensor
from .fista_gram import BatchFISTAConfig, GramBatch


class CVResult(NamedTuple):
    alphas: torch.Tensor  # (K,) descending
    mse_path: torch.Tensor  # (k_folds, K) per-fold validation MSE
    mse_mean: torch.Tensor  # (K,)
    mse_se: torch.Tensor  # (K,) standard error across folds
    best_alpha: torch.Tensor  # argmin of mse_mean (or 1-SE rule)
    best_idx: torch.Tensor
    coef: torch.Tensor  # (n,) full-data solution at best_alpha
    coef_path: torch.Tensor  # (K, n) full-data path
    coef_folds: torch.Tensor  # (k_folds, K, n) per-fold training solutions
    converged: torch.Tensor  # bool: every instance certified
    intercept: torch.Tensor  # scalar (0 unless fit_intercept)
    rel_gap: torch.Tensor  # (k_folds+1, K) per-instance certified relative gap
    converged_grid: torch.Tensor  # (k_folds+1, K) per-instance certification
    iters: torch.Tensor  # (k_folds+1, K) per-instance iteration counts


def _ladder(amax: torch.Tensor, n_alphas: int, eps: float, dtype) -> torch.Tensor:
    """Geometric ladder α_max → eps·α_max, computed on ``amax``'s device."""
    t = torch.arange(n_alphas, dtype=dtype, device=amax.device) / max(n_alphas - 1, 1)
    return amax * (eps ** t)


class _Folds(NamedTuple):
    A: torch.Tensor  # (k, f_hi, n), sentinel rows all-zero
    b: torch.Tensor  # (k, f_hi)
    valid: torch.Tensor  # (k, f_hi) bool: a real row, not the sentinel
    sizes: torch.Tensor  # (k,) int32 rows a fold


def _folds(A: torch.Tensor, b: torch.Tensor, k_folds: int) -> _Folds:
    """sklearn KFold's contiguous folds, padded to the largest fold by a
    gather against a sentinel zero row at index m."""
    m, n = A.shape
    f_lo, r = divmod(m, k_folds)
    f_hi = f_lo + (1 if r else 0)
    dev = A.device
    sizes = torch.tensor([f_lo + (1 if j < r else 0) for j in range(k_folds)],
                         dtype=torch.int32, device=dev)
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(f_hi, dtype=torch.int32, device=dev)
    valid = pos[None, :] < sizes[:, None]
    idx = torch.where(valid, starts[:, None] + pos[None, :], m).long()
    A_pad = torch.cat([A, A.new_zeros((1, n))])
    b_pad = torch.cat([b, b.new_zeros((1,))])
    return _Folds(A=A_pad[idx], b=b_pad[idx], valid=valid, sizes=sizes)


def _train_grams(A: torch.Tensor, b: torch.Tensor, folds: _Folds):
    """``(Q_all (k+1, n, n), c_all (k+1, n), btb_all (k+1,))``: the k
    fold-train problems by Gram subtraction, then the full-data problem."""
    Q_full = A.T @ A
    c_full = A.T @ b
    btb_full = b @ b
    Qf = torch.einsum("kfi,kfj->kij", folds.A, folds.A)
    cf = torch.einsum("kfi,kf->ki", folds.A, folds.b)
    btbf = torch.einsum("kf,kf->k", folds.b, folds.b)
    return (torch.cat([Q_full[None] - Qf, Q_full[None]]),
            torch.cat([c_full[None] - cf, c_full[None]]),
            torch.cat([btb_full - btbf, btb_full[None]]))


def _penalties(alphas: torch.Tensor, sizes: torch.Tensor, m: int, alpha2,
               l1_ratio: float):
    """Per-lane ``(α₁, α₂)`` of the group-major grid ((k+1)·K lanes): fold
    j's lanes scaled by (m − |fold j|)/m, the refit's by 1; α₂ is the fixed
    ``alpha2`` (scaled alike) plus α₁·(1 − l1_ratio)/l1_ratio, sklearn's
    ElasticNetCV ladder."""
    dtype, K = alphas.dtype, alphas.shape[0]
    train_frac = torch.cat([(m - sizes).to(dtype) / m,
                            torch.ones((1,), dtype=dtype, device=alphas.device)])
    scale_rep = torch.repeat_interleave(train_frac, K)
    a1_grid = alphas.repeat(sizes.shape[0] + 1) * scale_rep
    ratio = (1.0 - l1_ratio) / l1_ratio
    a2_grid = (torch.as_tensor(alpha2, dtype=dtype, device=alphas.device) * scale_rep
               + a1_grid * torch.as_tensor(ratio, dtype=dtype, device=alphas.device))
    return a1_grid, a2_grid


def _grid(Q_all, c_all, btb_all, L_all, a1_grid, a2_grid) -> GramBatch:
    """The (k+1)·K-lane ``GramBatch``, group-major: each problem repeated
    over the ladder; contiguous, so every engine reads it in one layout."""
    K = a1_grid.shape[0] // Q_all.shape[0]
    rep = lambda v: torch.repeat_interleave(v, K, dim=0)
    return GramBatch(Q=rep(Q_all).permute(1, 2, 0).contiguous(),
                     c=rep(c_all).T.contiguous(), btb=rep(btb_all),
                     alpha1=a1_grid, alpha2=a2_grid, L=rep(L_all) + a2_grid)


def _scores(folds: _Folds, X_folds: torch.Tensor, one_se_rule: bool):
    """``(mse_path, mse_mean, mse_se, best_idx)``: fold j's models predict
    fold j's rows; sentinel rows add no residual and stay out of the
    denominator."""
    dtype = X_folds.dtype
    k = folds.sizes.shape[0]
    preds = torch.einsum("kfi,kKi->kKf", folds.A, X_folds)
    sq = (preds - folds.b[:, None, :]) ** 2 * folds.valid[:, None, :].to(dtype)
    mse_path = torch.sum(sq, dim=-1) / folds.sizes.to(dtype)[:, None]
    mse_mean = torch.mean(mse_path, dim=0)
    mse_se = torch.std(mse_path, dim=0, correction=1) / torch.sqrt(
        torch.tensor(k, dtype=dtype, device=X_folds.device))
    i_min = torch.argmin(mse_mean)
    if one_se_rule:
        # the largest α (sparsest model) within one standard error of the
        # minimum: αs descend, so the first qualifying index
        ok = mse_mean <= mse_mean[i_min] + mse_se[i_min]
        best_idx = torch.argmax(ok.to(torch.int32))
    else:
        best_idx = i_min
    return mse_path, mse_mean, mse_se, best_idx


def _cv_core(A, b, alphas_in, k_folds: int, n_alphas: int, eps: float, alpha2,
             cfg: BatchFISTAConfig, one_se_rule: bool, l1_ratio: float = 1.0,
             backend: str = "auto") -> CVResult:
    from .api import solve_gram_batch

    m, n = A.shape
    folds = _folds(A, b, k_folds)
    Q_all, c_all, btb_all = _train_grams(A, b, folds)
    if alphas_in is None:
        alphas = _ladder(torch.amax(torch.abs(c_all[-1])), n_alphas, eps, A.dtype)
    else:
        alphas = torch.sort(as_tensor(alphas_in, A.dtype, A.device), descending=True).values
    K = alphas.shape[0]
    L_all = estimate_lipschitz_gram(Q_all)
    a1_grid, a2_grid = _penalties(alphas, folds.sizes, m, alpha2, l1_ratio)
    gb = _grid(Q_all, c_all, btb_all, L_all, a1_grid, a2_grid)
    res = solve_gram_batch(gb, cfg, backend=backend)

    X = res.x.reshape(k_folds + 1, K, n)
    X_folds, X_full = X[:k_folds], X[k_folds]
    mse_path, mse_mean, mse_se, best_idx = _scores(folds, X_folds, one_se_rule)
    return CVResult(
        alphas=alphas,
        mse_path=mse_path,
        mse_mean=mse_mean,
        mse_se=mse_se,
        best_alpha=alphas[best_idx],
        best_idx=best_idx,
        coef=X_full[best_idx],
        coef_path=X_full,
        coef_folds=X_folds,
        converged=torch.all(res.converged),
        intercept=A.new_zeros(()),
        rel_gap=res.rel_gap.reshape(k_folds + 1, K),
        converged_grid=res.converged.reshape(k_folds + 1, K),
        iters=res.iters.reshape(k_folds + 1, K),
    )


def cv_lasso(
    A,
    b,
    k_folds: int = 5,
    alphas=None,
    n_alphas: int = 50,
    eps: float = 1e-3,
    alpha2: float = 0.0,
    generator: torch.Generator | None = None,
    cfg: BatchFISTAConfig = BatchFISTAConfig(max_iter=2000, check_every=25),
    one_se_rule: bool = False,
    fit_intercept: bool = False,
    dtype: torch.dtype = torch.float32,
    l1_ratio: float = 1.0,
    backend: str = "auto",
    device=None,
) -> CVResult:
    """Cross-validated lasso (elastic-net with ``alpha2 > 0`` for a fixed
    extra ridge, or ``l1_ratio < 1`` for a ladder-tied elastic-net grid:
    ``alphas`` then ladder α₁ and each lane carries
    α₂ = α₁·(1−l1_ratio)/l1_ratio on top of ``alpha2``).

    ``A`` (m, n) and ``b`` (m,) are tensors, which keep their device, or
    numpy arrays, which go to ``device`` or, when none is named, to the card
    (raising without one). ``generator`` shuffles rows before folding
    (recommended for ordered data); folds are contiguous row blocks after
    the shuffle. ``one_se_rule=True`` applies the one-standard-error
    selection. ``fit_intercept=True`` centers ``A``'s columns and ``b`` first
    and reports the intercept for the refit coefficients. ``backend`` is
    ``solve_gram_batch``'s: ``"auto"`` takes a kernel on a CUDA tensor where
    the router's guards allow it.
    """
    A = as_tensor(A, dtype, device)
    b = as_tensor(b, dtype, A.device)
    if generator is not None:
        perm = torch.randperm(A.shape[0], generator=generator,
                              device=generator.device).to(A.device)
        A, b = A[perm], b[perm]
    mu_A = mu_b = None
    if fit_intercept:
        mu_A = A.mean(dim=0)
        mu_b = b.mean()
        A = A - mu_A
        b = b - mu_b
    if alphas is not None:
        n_alphas = len(alphas)
    if not 0.0 < l1_ratio <= 1.0:
        raise ValueError(f"l1_ratio must be in (0, 1], got {l1_ratio}")
    res = _cv_core(A, b, alphas, k_folds, n_alphas, eps, alpha2, cfg, one_se_rule,
                   l1_ratio=float(l1_ratio), backend=backend)
    if fit_intercept:
        res = res._replace(intercept=mu_b - mu_A @ res.coef)
    return res
