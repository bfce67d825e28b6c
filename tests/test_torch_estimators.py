"""The port's scikit-learn-style estimators (``fastoptsolver_tpu_torch.
estimators``) against the JAX package's, float64 on the CPU.

The two packages start their power iterations from other vectors (a
``torch.Generator`` against a ``jax.random`` key), so their fista/ista step
sizes differ in the last bits and their iterates part by rounding: each
estimator's ``coef_`` and ``intercept_`` are held to the JAX estimator's and
to the float64 optimum (CD, certified) at the reference's own 1e-6; Ridge's
L-BFGS, which draws nothing, to 1e-8 of the JAX fit. The CV estimators run
with ``shuffle_seed=None`` (a seed permutes rows by another generator than
the reference's): the ladders at 1e-12, ``mse_path_`` at 1e-6, the same
``alpha_``, ``coef_`` at 1e-5 of its largest entry (each lane certified to a
relative gap of 1e-7).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastoptsolver_tpu as J
import fastoptsolver_tpu_torch as T
from fastoptsolver_tpu_torch.batch import api
from fastoptsolver_tpu_torch.kernels import fista_vmem
from fastoptsolver_tpu_torch.problems import LeastSquares, NonNegativeLeastSquares
from fastoptsolver_tpu_torch.solvers import CDConfig, FISTAConfig, certified_optimum, fista

torch.set_num_threads(1)

COEF_ATOL = 1e-6


def _data(seed=0, m=200, n=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, n))
    w = np.zeros(n)
    w[:4] = rng.normal(size=4) * 2
    y = X @ w + 3.0 + 0.1 * rng.normal(size=m)
    return X, y


def _optimum(X, y, reg, a1, a2=0.0, w=None, fit_intercept=True):
    """The float64 lasso/elastic-net optimum of an estimator's problem."""
    if w is not None:
        w = w * (X.shape[0] / w.sum())
    if fit_intercept:
        mx = np.average(X, axis=0, weights=w)
        X, y = X - mx, y - np.average(y, weights=w)
    if w is not None:
        X, y = X * np.sqrt(w)[:, None], y * np.sqrt(w)
    p = LeastSquares.create(X, y, reg, a1, a2, dtype=torch.float64, device="cpu")
    return certified_optimum(p.to_gram(), CDConfig(max_sweeps=50000, tol=1e-15))[0].numpy()


PLAIN = {
    "lasso": (("Lasso", dict(alpha=0.05, max_iter=5000)), {}, ("lasso", 0.05 * 200)),
    "lasso_no_intercept": (("Lasso", dict(alpha=0.05, fit_intercept=False, max_iter=5000)), {},
                           ("lasso", 0.05 * 200)),
    "elasticnet_ista": (("ElasticNet", dict(alpha=0.05, l1_ratio=0.4, max_iter=20000,
                                            method="ista")), {},
                        ("elasticnet", 0.05 * 0.4 * 200, 0.05 * 0.6 * 200)),
    "lasso_weighted": (("Lasso", dict(alpha=0.02, max_iter=8000)), dict(weights=True),
                       ("lasso", 0.02 * 200)),
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_estimator_matches_jax(name):
    (cls, kw), fit_kw, reg = PLAIN[name]
    X, y = _data()
    w = np.random.default_rng(1).uniform(0.5, 2.0, X.shape[0]) if fit_kw else None
    fit = dict(sample_weight=w) if w is not None else {}
    est = getattr(T, cls)(**kw, dtype=torch.float64, device="cpu").fit(X, y, **fit)
    ref = getattr(J, cls)(**kw, dtype=jnp.float64).fit(X, y, **fit)
    x_star = _optimum(X, y, *reg, w=w, fit_intercept=kw.get("fit_intercept", True))
    assert est.coef_.dtype == np.float64 and est.coef_.shape == (X.shape[1],)
    np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF_ATOL)
    np.testing.assert_allclose(est.coef_, x_star, atol=COEF_ATOL)
    np.testing.assert_allclose(est.intercept_, ref.intercept_, atol=COEF_ATOL)
    assert est.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(est.predict(X), ref.predict(X), atol=1e-5)
    assert est.score(X, y) == pytest.approx(ref.score(X, y), abs=1e-9)


def test_ridge_matches_jax_and_the_closed_form():
    X, y = _data()
    est = T.Ridge(alpha=2.0, fit_intercept=False, dtype=torch.float64, device="cpu").fit(X, y)
    ref = J.Ridge(alpha=2.0, fit_intercept=False, dtype=jnp.float64).fit(X, y)
    w_ref = np.linalg.solve(X.T @ X + 2.0 * np.eye(X.shape[1]), X.T @ y)
    np.testing.assert_allclose(est.coef_, ref.coef_, atol=1e-8)
    np.testing.assert_allclose(est.coef_, w_ref, atol=1e-4)  # ftol-limited, as the reference


@pytest.mark.parametrize("method", ["fista", "ista"])
def test_positive_matches_jax(method):
    X, y = _data(seed=2)
    X[:, :6] *= -1.0  # half the true coefficients negative: the constraint binds
    kw = dict(alpha=0.01, positive=True, max_iter=5000 if method == "fista" else 20000,
              method=method)
    est = T.ElasticNet(**kw, l1_ratio=0.7, dtype=torch.float64, device="cpu").fit(X, y)
    ref = J.ElasticNet(**kw, l1_ratio=0.7, dtype=jnp.float64).fit(X, y)
    assert est.coef_.min() >= 0.0 and (est.coef_ == 0.0).any()
    np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF_ATOL)
    Xc, yc = X - X.mean(0), y - y.mean()
    m = X.shape[0]
    p = NonNegativeLeastSquares.create(Xc, yc, 0.01 * 0.7 * m, 0.01 * 0.3 * m,
                                       dtype=torch.float64, device="cpu")
    x_star = fista(p, FISTAConfig(max_iter=5000, adaptive_restart=True)).x.numpy()
    np.testing.assert_allclose(est.coef_, x_star, atol=COEF_ATOL)
    with pytest.raises(ValueError, match="positive"):
        T.Lasso(positive=True, method="lbfgs", device="cpu").fit(X, y)


def test_warm_start_and_sample_weight_checks():
    X, y = _data()
    est = T.Lasso(alpha=0.05, max_iter=3, warm_start=True, dtype=torch.float64, device="cpu")
    ref = J.Lasso(alpha=0.05, max_iter=3, warm_start=True, dtype=jnp.float64)
    for _ in range(3):  # each fit continues from the last coef_
        est.fit(X, y)
        ref.fit(X, y)
    cold = T.Lasso(alpha=0.05, max_iter=3, dtype=torch.float64, device="cpu").fit(X, y)
    x_star = _optimum(X, y, "lasso", 0.05 * 200)
    assert np.abs(est.coef_ - x_star).max() < np.abs(cold.coef_ - x_star).max()
    np.testing.assert_allclose(est.coef_, ref.coef_, atol=1e-4)  # 9 steps, L's last bits
    with pytest.raises(ValueError, match="shape"):
        T.Lasso(device="cpu").fit(X, y, sample_weight=np.ones(3))
    with pytest.raises(ValueError, match="nonnegative"):
        T.Lasso(device="cpu").fit(X, y, sample_weight=-np.ones(X.shape[0]))


def test_multitask_lasso_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(150, 12))
    W = np.zeros((12, 4))
    W[[0, 3, 7]] = rng.normal(size=(3, 4)) + 1.5
    Y = A @ W + 0.05 * rng.normal(size=(150, 4)) + 1.0
    for fit_intercept in (True, False):
        kw = dict(alpha=0.1, max_iter=8000, fit_intercept=fit_intercept)
        est = T.MultiTaskLasso(**kw, dtype=torch.float64, device="cpu").fit(A, Y)
        ref = J.MultiTaskLasso(**kw, dtype=jnp.float64).fit(A, Y)
        assert est.coef_.shape == (4, 12) and est.intercept_.shape == (4,)
        np.testing.assert_allclose(est.coef_, ref.coef_, atol=COEF_ATOL)
        np.testing.assert_allclose(est.intercept_, ref.intercept_, atol=COEF_ATOL)
        assert est.score(A, Y) == pytest.approx(ref.score(A, Y), abs=1e-9)
    assert (np.linalg.norm(est.coef_, axis=0) == 0.0).sum() >= 3  # rows die together


def _hold_cv(est, ref):
    np.testing.assert_allclose(est.alphas_, ref.alphas_, rtol=1e-12)
    assert est.mse_path_.shape == ref.mse_path_.shape
    np.testing.assert_allclose(est.mse_path_, ref.mse_path_, rtol=1e-6)
    assert est.alpha_ == pytest.approx(ref.alpha_, rel=1e-12)
    np.testing.assert_allclose(est.coef_, ref.coef_, atol=1e-5 * np.abs(ref.coef_).max())
    np.testing.assert_allclose(est.coef_path_, ref.coef_path_,
                               atol=1e-5 * np.abs(ref.coef_path_).max())
    assert est.intercept_ == pytest.approx(ref.intercept_, abs=1e-5)
    assert est.converged_ == ref.converged_


def test_lasso_cv_matches_jax():
    X, y = _data(seed=4)
    kw = dict(n_alphas=12, cv=4, shuffle_seed=None)
    est = T.LassoCV(**kw, dtype=torch.float64, device="cpu").fit(X, y)
    ref = J.LassoCV(**kw, dtype=jnp.float64).fit(X, y)
    _hold_cv(est, ref)
    assert est.mse_path_.shape == (12, 4)
    one = T.LassoCV(**kw, one_se_rule=True, dtype=torch.float64, device="cpu").fit(X, y)
    assert one.alpha_ >= est.alpha_


def test_elasticnet_cv_matches_jax():
    X, y = _data(seed=5)
    kw = dict(l1_ratio=[0.5, 0.9], alphas=[0.5, 0.1, 0.02, 0.004], cv=5, shuffle_seed=None)
    est = T.ElasticNetCV(**kw, dtype=torch.float64, device="cpu").fit(X, y)
    ref = J.ElasticNetCV(**kw, dtype=jnp.float64).fit(X, y)
    _hold_cv(est, ref)
    assert est.mse_path_.shape == (2, 4, 5) and est.alphas_.shape == (2, 4)
    assert est.l1_ratio_ == ref.l1_ratio_ == est.l1_ratio
    one = T.ElasticNetCV(l1_ratio=0.7, n_alphas=6, shuffle_seed=None, dtype=torch.float64,
                         device="cpu").fit(X, y)
    assert one.mse_path_.shape == (6, 5) and one.l1_ratio_ == 0.7


def test_a_shuffle_seed_gives_the_same_bits_twice():
    X, y = _data(seed=6)
    fit = lambda seed: T.LassoCV(n_alphas=6, shuffle_seed=seed, device="cpu").fit(X, y)
    a, b, none = fit(3), fit(3), fit(None)
    for attr in ("mse_path_", "coef_", "coef_path_", "alphas_"):
        assert np.array_equal(getattr(a, attr), getattr(b, attr)), attr
    assert a.intercept_ == b.intercept_
    assert not np.array_equal(a.mse_path_, none.mse_path_)
    assert a.coef_.dtype == np.float64


def test_cv_grid_through_the_burst_twin(monkeypatch):
    """``LassoCV`` with ``cv_lasso``'s grid on the burst engine's plain twin
    (``solve_gram_batch`` given ``interpret=True``, as a CPU tensor needs for
    the kernel route) against the same fit on the torch driver: every burst
    of the (folds + 1)·α grid launched on the twin, the same ``alpha_``,
    ``mse_path_`` within 1e-5, the refit ``coef_`` within 1e-4 of its
    largest entry (float32, each lane certified to 1e-7 or run to
    ``max_iter``)."""
    X, y = _data(seed=7, m=203)
    launches = []
    twin = fista_vmem._burst_reference

    def counted(*args, **kw):
        launches.append(args[2].shape)
        return twin(*args, **kw)

    kw = dict(n_alphas=8, cv=5, shuffle_seed=0, device="cpu")
    driver = T.LassoCV(**kw).fit(X, y)
    assert not launches
    monkeypatch.setattr(fista_vmem, "_burst_reference", counted)
    monkeypatch.setattr(api, "solve_gram_batch",
                        functools.partial(api.solve_gram_batch, interpret=True))
    est = T.LassoCV(**kw).fit(X, y)
    assert launches and all(s == (12, 12, 6 * 8) for s in launches)
    assert est.alpha_ == driver.alpha_
    np.testing.assert_allclose(est.mse_path_, driver.mse_path_, rtol=1e-5)
    np.testing.assert_allclose(est.coef_, driver.coef_, atol=1e-4 * np.abs(driver.coef_).max())


def test_device_rule(monkeypatch):
    """NumPy goes to the card unless a device is named: with no card every
    estimator raises, and ``device="cpu"`` runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data()
    for est in (T.Lasso(max_iter=3), T.Ridge(max_iter=3), T.Lasso(positive=True, max_iter=3),
                T.LassoCV(n_alphas=3), T.ElasticNetCV(n_alphas=3),
                T.LassoCV(n_alphas=3, shuffle_seed=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            est.fit(X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MultiTaskLasso(max_iter=3).fit(X, np.stack([y, y], 1))
    assert T.ElasticNet(max_iter=3, device="cpu").fit(X, y).coef_.shape == (12,)
    assert T.LassoCV(n_alphas=3, device="cpu").fit(X, y).mse_path_.shape == (3, 5)
    est = T.MultiTaskLasso(max_iter=3, device="cpu").fit(X, np.stack([y, y], 1))
    assert est.coef_.shape == (2, 12)
