"""scikit-learn-style estimators: fit / predict / score over the port's
solvers (port of ``fastoptsolver_tpu/estimators.py``).

``Lasso``, ``ElasticNet``, ``Ridge``, ``MultiTaskLasso`` and the
cross-validated ``LassoCV`` and ``ElasticNetCV``; NumPy in, NumPy float64
out. The plain estimators run ``api.solve`` (``fista`` by default, on the
Gram form where it pays) or, with ``positive=True``, fista/ista on a
``NonNegativeLeastSquares``. The CV estimators run ``batch.cv_lasso``, whose
(folds + 1)·α grid goes through ``solve_gram_batch``: on the card the burst
kernel (``csrc/fista_burst.cu``) at n ≤ 104 and the resident kernel to
n = 168, the torch driver on the CPU.

Conventions follow scikit-learn: it minimizes ``1/(2·n_samples)·‖y − Xw‖² +
α·l1_ratio·‖w‖₁ + ½·α·(1−l1_ratio)·‖w‖²``, the package ``½‖Ax−b‖² +
α₁‖x‖₁ + ½·α₂‖x‖²``, so ``α₁ = n_samples·α·l1_ratio`` and ``α₂ =
n_samples·α·(1−l1_ratio)``. Intercepts: center X's columns and y, never
penalize the intercept.

Differences from the reference: ``dtype`` is a torch dtype
(``torch.float32`` by default); every class takes ``device=`` last, where the
data go (the card when none is named, raising without one, as the package's
other entry points take numpy); ``shuffle_seed`` seeds a ``torch.Generator``
on that device where the reference makes ``jax.random.PRNGKey``, so a seed
gives another fold permutation than the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import solve
from .batch.cv import cv_lasso
from .batch.fista_gram import BatchFISTAConfig
from .problems.base import as_tensor, target_device


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _generator(seed, device) -> torch.Generator | None:
    """A generator on the data's device seeded with ``seed``, or None."""
    if seed is None:
        return None
    return torch.Generator(device=target_device(device)).manual_seed(int(seed))


class _BaseRegressor:
    """Shared fit/predict/score plumbing (NumPy in, NumPy out)."""

    def __init__(self, alpha=1.0, l1_ratio=1.0, fit_intercept=True, max_iter=2000,
                 tol=0.0, method="fista", dtype=torch.float32, positive=False,
                 warm_start=False, device=None):
        self.alpha = float(alpha)
        self.l1_ratio = float(l1_ratio)
        self.fit_intercept = bool(fit_intercept)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.method = method
        self.dtype = dtype
        self.positive = bool(positive)
        self.warm_start = bool(warm_start)
        self.device = device

    def _reg(self, n_samples: int) -> tuple[str, float, float]:
        a1 = n_samples * self.alpha * self.l1_ratio
        a2 = n_samples * self.alpha * (1.0 - self.l1_ratio)
        if a1 == 0.0:
            return "ridge", 0.0, a2
        if a2 == 0.0:
            return "lasso", a1, 0.0
        return "elasticnet", a1, a2

    def _x0(self, clip: bool = False):
        """sklearn's ``warm_start``: the previous fit's coefficients."""
        if not (self.warm_start and hasattr(self, "coef_")):
            return None
        coef = np.maximum(self.coef_, 0.0) if clip else self.coef_
        return as_tensor(coef, self.dtype, self.device)

    def fit(self, X, y, sample_weight=None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        if sample_weight is not None:
            # sklearn semantics: weights rescaled to sum to n_samples, the
            # weighted means for centering, the solve on rows scaled by √wᵢ
            # (the weighted least-squares objective exactly)
            w = np.asarray(sample_weight, np.float64)
            if w.shape != (X.shape[0],):
                raise ValueError(f"sample_weight has shape {w.shape}, expected ({X.shape[0]},)")
            if np.any(w < 0):
                raise ValueError("sample_weight must be nonnegative")
            w = w * (X.shape[0] / w.sum())
        else:
            w = None
        if self.fit_intercept:
            if w is None:
                self._x_mean = X.mean(axis=0)
                self._y_mean = y.mean()
            else:
                self._x_mean = np.average(X, axis=0, weights=w)
                self._y_mean = float(np.average(y, weights=w))
            Xc, yc = X - self._x_mean, y - self._y_mean
        else:
            self._x_mean = np.zeros(X.shape[1])
            self._y_mean = 0.0
            Xc, yc = X, y
        if w is not None:
            sw = np.sqrt(w)
            Xc = Xc * sw[:, None]
            yc = yc * sw
        reg, a1, a2 = self._reg(X.shape[0])
        if self.positive:
            # coefficients ≥ 0: another problem type on the unchanged
            # proximal solvers; other methods cannot honor the constraint
            if self.method not in ("fista", "ista"):
                raise ValueError("positive=True requires a proximal method (fista/ista); "
                                 f"got method={self.method!r}")
            from .problems import NonNegativeLeastSquares
            from .solvers import FISTAConfig, ISTAConfig, fista, ista

            prob = NonNegativeLeastSquares.create(Xc, yc, alpha1=a1, alpha2=a2,
                                                  dtype=self.dtype, device=self.device)
            run, cfg = (ista, ISTAConfig) if self.method == "ista" else (fista, FISTAConfig)
            res = run(prob, cfg(max_iter=self.max_iter, tol=self.tol), x0=self._x0(clip=True))
        else:
            kwargs = dict(max_iter=self.max_iter)
            if self.method in ("fista", "ista", "lbfgs", "owlqn"):
                kwargs["tol"] = self.tol
            res = solve(Xc, yc, reg, alpha1=a1, alpha2=a2, method=self.method,
                        dtype=self.dtype, x0=self._x0(), device=self.device, **kwargs)
        self.coef_ = _np64(res.x)
        self.intercept_ = float(self._y_mean - self._x_mean @ self.coef_)
        self.n_iter_ = int(res.n_iters)
        return self

    def predict(self, X):
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_

    def score(self, X, y):
        """R² (coefficient of determination), sklearn semantics."""
        y = np.asarray(y, np.float64)
        r = y - self.predict(X)
        ss_res = float(r @ r)
        d = y - y.mean()
        ss_tot = float(d @ d)
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


class Lasso(_BaseRegressor):
    """L1-regularized least squares (sklearn.linear_model.Lasso's
    hyperparameter semantics)."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=2000, tol=0.0,
                 method="fista", dtype=torch.float32, positive=False, warm_start=False,
                 device=None):
        super().__init__(alpha=alpha, l1_ratio=1.0, fit_intercept=fit_intercept,
                         max_iter=max_iter, tol=tol, method=method, dtype=dtype,
                         positive=positive, warm_start=warm_start, device=device)


class ElasticNet(_BaseRegressor):
    """Elastic net (sklearn's alpha/l1_ratio semantics)."""

    def __init__(self, alpha=1.0, l1_ratio=0.5, fit_intercept=True, max_iter=2000,
                 tol=0.0, method="fista", dtype=torch.float32, positive=False,
                 warm_start=False, device=None):
        super().__init__(alpha=alpha, l1_ratio=l1_ratio, fit_intercept=fit_intercept,
                         max_iter=max_iter, tol=tol, method=method, dtype=dtype,
                         positive=positive, warm_start=warm_start, device=device)


class Ridge(_BaseRegressor):
    """L2-regularized least squares. sklearn's Ridge does not scale α by
    n_samples, and neither does this (α₂ = α)."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=500, tol=1e-9,
                 method="lbfgs", dtype=torch.float32, device=None):
        super().__init__(alpha=alpha, l1_ratio=0.0, fit_intercept=fit_intercept,
                         max_iter=max_iter, tol=tol, method=method, dtype=dtype,
                         device=device)

    def _reg(self, n_samples):
        return "ridge", 0.0, self.alpha


class MultiTaskLasso:
    """Joint-sparsity multi-task lasso (sklearn.linear_model.MultiTaskLasso
    semantics): minimizes ``1/(2·n_samples)·‖Y − XW‖_F² + α·Σ_j ‖W_{j,:}‖₂``
    over W ∈ R^{n_features × n_tasks}, all tasks on one support, by the
    matrix-iterate FISTA on ``problems.MultiTaskLeastSquares`` (α₁ =
    n_samples·α). ``coef_`` is (n_tasks, n_features) as sklearn's,
    ``intercept_`` (n_tasks,). The power iteration starts from a generator
    seeded with 0 on the data's device, where the reference passes
    ``PRNGKey(0)``."""

    def __init__(self, alpha=1.0, fit_intercept=True, max_iter=2000, tol=0.0,
                 dtype=torch.float32, device=None):
        self.alpha = float(alpha)
        self.fit_intercept = bool(fit_intercept)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.dtype = dtype
        self.device = device

    def fit(self, X, Y):
        from .problems import MultiTaskLeastSquares
        from .solvers import FISTAConfig, fista

        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        if self.fit_intercept:
            self._x_mean = X.mean(axis=0)
            self._y_mean = Y.mean(axis=0)
            Xc, Yc = X - self._x_mean, Y - self._y_mean
        else:
            self._x_mean = np.zeros(X.shape[1])
            self._y_mean = np.zeros(Y.shape[1])
            Xc, Yc = X, Y
        problem = MultiTaskLeastSquares.create(Xc, Yc, alpha1=X.shape[0] * self.alpha,
                                               dtype=self.dtype, device=self.device)
        res = fista(problem, FISTAConfig(max_iter=self.max_iter, tol=self.tol),
                    generator=_generator(0, problem.A.device))
        W = _np64(res.x)  # (n_features, n_tasks)
        self.coef_ = W.T
        self.intercept_ = self._y_mean - self._x_mean @ W
        self.n_iter_ = int(res.n_iters)
        return self

    def predict(self, X):
        return np.asarray(X, np.float64) @ self.coef_.T + self.intercept_

    def score(self, X, Y):
        """Mean R² across tasks (sklearn's multioutput='uniform_average')."""
        Y = np.asarray(Y, np.float64)
        R = Y - self.predict(X)
        ss_res = np.sum(R * R, axis=0)
        D = Y - Y.mean(axis=0)
        ss_tot = np.sum(D * D, axis=0)
        return float(np.mean(1.0 - ss_res / np.where(ss_tot > 0, ss_tot, 1.0)))


class _CVRegressor(_BaseRegressor):
    """The CV estimators' shared ``cv_lasso`` call and attributes."""

    def _init_cv(self, alphas, n_alphas, eps, cv, one_se_rule, shuffle_seed):
        self.alphas = alphas
        self.n_alphas = int(n_alphas)
        self.eps = float(eps)
        self.cv = int(cv)
        self.one_se_rule = bool(one_se_rule)
        self.shuffle_seed = shuffle_seed

    def _cv(self, X, y, l1_ratio: float):
        """One ``cv_lasso`` call at ``l1_ratio``: ``(CVResult, scale)`` with
        scale = m·l1_ratio the map from sklearn's α to α₁."""
        scale = X.shape[0] * l1_ratio
        alphas = None if self.alphas is None else np.asarray(self.alphas, np.float64) * scale
        res = cv_lasso(X, y, k_folds=self.cv, alphas=alphas, n_alphas=self.n_alphas,
                       eps=self.eps, generator=_generator(self.shuffle_seed, self.device),
                       cfg=BatchFISTAConfig(max_iter=self.max_iter, check_every=25,
                                            rel_gap_tol=1e-7),
                       one_se_rule=self.one_se_rule, fit_intercept=self.fit_intercept,
                       dtype=self.dtype, l1_ratio=l1_ratio, device=self.device)
        return res, scale

    def _take(self, res, scale: float):
        """The refit's attributes of the chosen ``cv_lasso`` result."""
        self.alpha_ = float(res.best_alpha) / scale
        self.coef_ = _np64(res.coef)
        self.coef_path_ = _np64(res.coef_path)
        self.intercept_ = float(res.intercept)
        self.converged_ = bool(res.converged)
        self.n_iter_ = int(res.iters[-1, int(res.best_idx)])  # the refit lane


class ElasticNetCV(_CVRegressor):
    """K-fold cross-validated elastic net (sklearn.linear_model.ElasticNetCV
    semantics): the α ladder carries both penalties (α₁ = m·α·l1_ratio,
    α₂ = m·α·(1−l1_ratio)), and per l1_ratio the (folds × ladder) grid and
    the refit path are one ``cv_lasso`` call. ``l1_ratio`` may be a float
    or a list; with a list the (l1_ratio, α) pair of least mean validation
    MSE wins. After ``fit``: ``alpha_``, ``l1_ratio_``, ``alphas_``,
    ``mse_path_`` ((n_alphas, cv), or (n_l1_ratio, n_alphas, cv) for a
    list), ``coef_``, ``intercept_``, ``coef_path_``, ``n_iter_``."""

    def __init__(self, l1_ratio=0.5, alphas=None, n_alphas=100, eps=1e-3, cv=5,
                 fit_intercept=True, max_iter=2000, one_se_rule=False, shuffle_seed=0,
                 dtype=torch.float32, device=None):
        is_list = isinstance(l1_ratio, (list, tuple, np.ndarray))
        ratios = [float(r) for r in l1_ratio] if is_list else [float(l1_ratio)]
        super().__init__(alpha=1.0, l1_ratio=ratios[0], fit_intercept=fit_intercept,
                         max_iter=max_iter, dtype=dtype, device=device)
        self._l1_ratios = ratios
        self._ratio_is_list = is_list
        self._init_cv(alphas, n_alphas, eps, cv, one_se_rule, shuffle_seed)

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        runs = [self._cv(X, y, r) for r in self._l1_ratios]
        best_r = int(np.argmin([float(res.mse_mean[res.best_idx]) for res, _ in runs]))
        res, scale = runs[best_r]
        self.l1_ratio_ = self._l1_ratios[best_r]
        self.l1_ratio = self.l1_ratio_  # refit semantics for _BaseRegressor
        if self._ratio_is_list:
            self.alphas_ = np.stack([_np64(r.alphas) / s for r, s in runs])
            self.mse_path_ = np.stack([_np64(r.mse_path).T for r, _ in runs])
        else:
            self.alphas_ = _np64(res.alphas) / scale
            self.mse_path_ = _np64(res.mse_path).T
        self._take(res, scale)
        return self


class LassoCV(_CVRegressor):
    """K-fold cross-validated lasso over an α ladder: the (folds × ladder)
    grid and the refit path are one ``cv_lasso`` call. After ``fit``:
    ``alpha_``, ``alphas_``, ``mse_path_`` ((n_alphas, cv), sklearn's
    orientation), ``coef_``, ``intercept_``, ``coef_path_``, ``n_iter_``."""

    def __init__(self, alphas=None, n_alphas=100, eps=1e-3, cv=5, fit_intercept=True,
                 max_iter=2000, one_se_rule=False, shuffle_seed=0, dtype=torch.float32,
                 device=None):
        super().__init__(alpha=1.0, l1_ratio=1.0, fit_intercept=fit_intercept,
                         max_iter=max_iter, dtype=dtype, device=device)
        self._init_cv(alphas, n_alphas, eps, cv, one_se_rule, shuffle_seed)

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        res, scale = self._cv(X, y, 1.0)
        self.alphas_ = _np64(res.alphas) / scale
        self.mse_path_ = _np64(res.mse_path).T  # (n_alphas, cv)
        self._take(res, scale)
        return self
