"""The port's regularization path and cross-validation (``batch.path``,
``batch.cv``) against the JAX package's on the CPU, both on their drivers.

``cv_lasso`` at m = 203 (ragged folds: 41, 41, 41, 40, 40 rows) and n = 12,
5 folds × 8 alphas, as lasso, with an intercept, with the one-SE rule and as
an elastic-net ladder (``l1_ratio=0.5``). The two packages start their
Lipschitz estimates from other vectors (``ops.lipschitz``), so their step
sizes differ in the last bits and the f32 iterates part; the results are
held where that cannot move them: the alphas at 1e-6, ``mse_path`` at 1e-4,
the float64 objective of every lane both certify at 1e-5 (each certificate
bounds its objective to 1e-6 above the optimum), the same ``best_idx``, and
``converged_grid`` equal on the lanes whose JAX gap is outside [0.5, 2]×
the tolerance (nearer it, the f32 gap certifies by its last bits). The data
have noise σ = 3 beside a signal of norm ~4: with less noise bᵀb dwarfs the
objective and the f32 gap's own rounding (its floor, in both packages) reaches
2-3× the tolerance, where a lane certifies or not by its last bits.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch import cv_lasso as jax_cv, lasso_path as jax_path
from fastoptsolver_tpu.problems import LeastSquares as JLS
from fastoptsolver_tpu_torch.batch import (
    BatchFISTAConfig,
    alpha_ladder,
    alpha_max_for,
    cv_lasso,
    lasso_path,
    path_gram_batch,
)
from fastoptsolver_tpu_torch.batch import api
from fastoptsolver_tpu_torch.kernels import fista_vmem
from fastoptsolver_tpu_torch.problems import LeastSquares

torch.set_num_threads(1)

M, N, K_FOLDS, N_ALPHAS = 203, 12, 5, 8
TOL = 1e-6  # the default config's rel_gap_tol


def _data(seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_true = np.zeros(n)
    x_true[: n // 3] = 2.0 * rng.normal(size=n // 3)
    b = A @ x_true + 3.0 * rng.normal(size=m) + 0.5
    return A.astype(np.float32), b.astype(np.float32)


def lane_objectives(A, b, res, l1_ratio=1.0, fit_intercept=False):
    """Every lane's objective in float64, from the rows of its fold-train set
    (sklearn KFold's contiguous folds) and its scaled penalties; (k+1, K)."""
    A, b = A.astype(np.float64), b.astype(np.float64)
    if fit_intercept:
        A, b = A - A.mean(0), b - b.mean()
    m = A.shape[0]
    sizes = [m // K_FOLDS + (1 if j < m % K_FOLDS else 0) for j in range(K_FOLDS)]
    starts = np.cumsum([0] + sizes)
    X = np.concatenate([np.asarray(res.coef_folds), np.asarray(res.coef_path)[None]])
    alphas = np.asarray(res.alphas, np.float64)
    out = np.empty(X.shape[:2])
    for j in range(K_FOLDS + 1):
        rows = np.ones(m, bool)
        if j < K_FOLDS:
            rows[starts[j]:starts[j + 1]] = False
        for i, a in enumerate(alphas):
            x = X[j, i].astype(np.float64)
            a1 = a * rows.sum() / m
            a2 = a1 * (1.0 - l1_ratio) / l1_ratio
            r = A[rows] @ x - b[rows]
            out[j, i] = 0.5 * r @ r + 0.5 * a2 * x @ x + a1 * np.abs(x).sum()
    return out


CASES = {"lasso": {}, "intercept": dict(fit_intercept=True),
         "one_se": dict(one_se_rule=True), "enet": dict(l1_ratio=0.5)}


@pytest.fixture(scope="module")
def cv_pairs():
    A, b = _data()
    return A, b, {name: (jax_cv(A, b, k_folds=K_FOLDS, n_alphas=N_ALPHAS, **kw),
                         cv_lasso(A, b, k_folds=K_FOLDS, n_alphas=N_ALPHAS, device="cpu", **kw))
                  for name, kw in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_cv_matches_jax(cv_pairs, case):
    A, b, pairs = cv_pairs
    rj, rt = pairs[case]
    kw = CASES[case]
    np.testing.assert_allclose(rt.alphas.numpy(), np.asarray(rj.alphas), rtol=1e-6)
    np.testing.assert_allclose(rt.mse_path.numpy(), np.asarray(rj.mse_path), rtol=1e-4)
    np.testing.assert_allclose(rt.mse_mean.numpy(), np.asarray(rj.mse_mean), rtol=1e-4)
    assert int(rt.best_idx) == int(rj.best_idx)
    np.testing.assert_allclose(float(rt.best_alpha), float(rj.best_alpha), rtol=1e-6)
    l1 = kw.get("l1_ratio", 1.0)
    fi = kw.get("fit_intercept", False)
    fj = lane_objectives(A, b, rj, l1, fi)
    ft = lane_objectives(A, b, rt, l1, fi)
    both = np.asarray(rj.converged_grid) & rt.converged_grid.numpy()
    assert both.sum() >= 0.5 * both.size
    np.testing.assert_allclose(ft[both], fj[both], rtol=1e-5)
    gap_j = np.asarray(rj.rel_gap)
    clear = (gap_j < 0.5 * TOL) | (gap_j > 2.0 * TOL)
    assert np.array_equal(rt.converged_grid.numpy()[clear], np.asarray(rj.converged_grid)[clear])
    np.testing.assert_allclose(float(rt.intercept), float(rj.intercept), rtol=1e-4, atol=1e-5)
    assert rt.coef_folds.shape == (K_FOLDS, N_ALPHAS, N) and rt.coef.shape == (N,)
    assert bool(rt.converged) == bool(rt.converged_grid.all())


@pytest.mark.parametrize("l1_ratio", [1.0, 0.5])
def test_cv_grid_through_the_burst_twin(monkeypatch, l1_ratio):
    """The grid through ``solve_gram_batch(..., interpret=True)``: the burst
    engine's plain twin, with α₂ varying by lane under the elastic-net
    ladder, against the driver on the same data. ``cv_lasso`` reaches the
    router as ``api.solve_gram_batch``; the stand-in adds ``interpret=True``,
    which a CPU tensor needs to take the kernel route."""
    A, b = _data(seed=1)
    launches = []
    twin = fista_vmem._burst_reference
    route = api.solve_gram_batch

    def counted(*args, **kw):
        launches.append(args[2].shape)
        return twin(*args, **kw)
    monkeypatch.setattr(fista_vmem, "_burst_reference", counted)
    monkeypatch.setattr(api, "solve_gram_batch", functools.partial(route, interpret=True))
    kw = dict(k_folds=K_FOLDS, n_alphas=N_ALPHAS, l1_ratio=l1_ratio, device="cpu")
    rk = cv_lasso(A, b, backend="kernel", **kw)
    rx = cv_lasso(A, b, backend="xla", **kw)
    assert launches and all(s == (N, N, (K_FOLDS + 1) * N_ALPHAS) for s in launches)
    np.testing.assert_allclose(rk.mse_mean.numpy(), rx.mse_mean.numpy(), rtol=1e-5)
    assert int(rk.best_idx) == int(rx.best_idx)
    both = rk.converged_grid.numpy() & rx.converged_grid.numpy()
    assert both.sum() >= 0.5 * both.size
    fk, fx = lane_objectives(A, b, rk, l1_ratio), lane_objectives(A, b, rx, l1_ratio)
    np.testing.assert_allclose(fk[both], fx[both], rtol=1e-5)
    if l1_ratio < 1.0:
        a2 = rk.alphas * (1.0 - l1_ratio) / l1_ratio
        assert float(a2.max() / a2.min()) > 10.0


def test_cv_given_alphas_and_shuffle():
    """Given alphas come back sorted descending; a generator's shuffle is
    the same permutation twice, and another than no shuffle."""
    A, b = _data(seed=2)
    kw = dict(k_folds=K_FOLDS, device="cpu", alphas=[0.5, 5.0, 50.0, 1.0])
    r1 = cv_lasso(A, b, generator=torch.Generator().manual_seed(3), **kw)
    r2 = cv_lasso(A, b, generator=torch.Generator().manual_seed(3), **kw)
    r0 = cv_lasso(A, b, **kw)
    assert r1.alphas.tolist() == [50.0, 5.0, 1.0, 0.5]
    assert torch.equal(r1.mse_path, r2.mse_path) and torch.equal(r1.coef_folds, r2.coef_folds)
    assert not torch.equal(r1.mse_path, r0.mse_path)
    with pytest.raises(ValueError, match="l1_ratio"):
        cv_lasso(A, b, l1_ratio=0.0, device="cpu")


def test_numpy_input_without_a_card_raises(monkeypatch):
    A, b = _data(seed=3, m=30, n=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cv_lasso(A, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alpha_ladder(1.0)
    # tensors keep their device
    r = cv_lasso(torch.from_numpy(A), torch.from_numpy(b), n_alphas=3)
    assert r.coef.device.type == "cpu"


def test_ladder_helpers_match_jax():
    from fastoptsolver_tpu.batch import alpha_ladder as j_ladder, alpha_max_for as j_amax
    from fastoptsolver_tpu.batch import path_gram_batch as j_pgb

    np.testing.assert_array_equal(alpha_ladder(3.7, 9, 1e-2, device="cpu").numpy(),
                                  np.asarray(j_ladder(3.7, 9, 1e-2)))
    c = np.random.default_rng(4).normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_array_equal(alpha_max_for(torch.from_numpy(c)).numpy(),
                                  np.asarray(j_amax(jnp.asarray(c))))
    Q = np.eye(3, dtype=np.float32) * 2.0
    cq, btb, L = np.ones(3, np.float32), np.float32(4.0), np.float32(2.0)
    al = np.array([3.0, 2.0, 1.0], np.float32)
    gj = j_pgb(jnp.asarray(Q), jnp.asarray(cq), jnp.asarray(btb), jnp.asarray(L),
               jnp.asarray(al), 0.5)
    gt = path_gram_batch(torch.from_numpy(Q), torch.from_numpy(cq), torch.tensor(btb),
                         torch.tensor(L), torch.from_numpy(al), 0.5)
    for f in ("Q", "c", "btb", "alpha1", "alpha2", "L"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)))


@pytest.mark.parametrize("warm_start", [False, True])
def test_lasso_path_matches_jax(warm_start):
    """Batched and warm-started paths, dense and Gram problem: the alphas at
    1e-6, the float64 objective of lanes both certify at 1e-5, and
    ``converged`` equal where the JAX gap is clear of the tolerance."""
    A, b = _data(seed=5, m=60, n=8)
    cfg = BatchFISTAConfig(max_iter=2000, check_every=25)
    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig

    jcfg = JaxConfig(max_iter=2000, check_every=25)
    for gram in (False, True):
        jp = JLS.create(A, b, "lasso")
        tp = LeastSquares.create(A, b, "lasso", device="cpu")
        if gram:
            jp, tp = jp.to_gram(), tp.to_gram()
        aj, rj = jax_path(jp, n_alphas=6, cfg=jcfg, warm_start=warm_start)
        at, rt = lasso_path(tp, n_alphas=6, cfg=cfg, warm_start=warm_start)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
        A64, b64 = A.astype(np.float64), b.astype(np.float64)

        def objective(x, a):
            r = A64 @ x.astype(np.float64) - b64
            return 0.5 * r @ r + a * np.abs(x).sum()
        fj = np.array([objective(np.asarray(x), a) for x, a in zip(rj.x, np.asarray(aj))])
        ft = np.array([objective(x.numpy(), float(a)) for x, a in zip(rt.x, at)])
        both = np.asarray(rj.converged) & rt.converged.numpy()
        assert both.sum() >= 4
        np.testing.assert_allclose(ft[both], fj[both], rtol=1e-5)
        gap = np.asarray(rj.rel_gap)
        clear = (gap < 0.5 * TOL) | (gap > 2.0 * TOL)
        assert np.array_equal(rt.converged.numpy()[clear], np.asarray(rj.converged)[clear])
        assert rt.x.shape == (6, 8)
