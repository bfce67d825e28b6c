"""The port's sparse problem (``problems.sparse``), the Boston configuration
(``problems.boston``) and the generalized lasso (``solvers.genlasso``),
against the JAX package, dense twins and NumPy oracles, float64.

- Sparse: a CSR problem and the dense ``LeastSquares`` run the same
  recurrence with the same L, so x agrees to 1e-10 over 1000 iterations;
  ``lipschitz`` to 1e-6 of ``eigvalsh``; the Gram to 1e-12.
- genlasso: the port and JAX run the same ADMM iterations from the same
  eigendecomposition up to rounding (two LAPACK builds), so x is held to
  1e-10 and the iteration counts equal; the solutions against CD's optimum
  (1e-5) and the 1D TV oracle (1e-6), the reference's own tolerances.
"""
import csv

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from fastoptsolver_tpu import problems as JP
from fastoptsolver_tpu.solvers import genlasso as JG
from fastoptsolver_tpu_torch import problems as TP
from fastoptsolver_tpu_torch import solvers as TS
from fastoptsolver_tpu_torch.batch import stack_problems
from oracle_np import objective_np, shrink, tv1d_np

torch.set_num_threads(1)

X_ATOL = 1e-10


def _sparse_data(seed=0, m=300, n=40, density=0.08):
    rng = np.random.default_rng(seed)
    A = (rng.random((m, n)) < density) * rng.normal(size=(m, n))
    for j in range(n):  # no all-zero column
        if not A[:, j].any():
            A[rng.integers(m), j] = rng.normal()
    x_true = np.zeros(n)
    x_true[: n // 4] = rng.normal(size=n // 4) * 2
    b = A @ x_true + 0.05 * rng.normal(size=m)
    return A, b


def _sp(A, b, reg="lasso", a1=0.5, a2=0.0):
    return TP.SparseLeastSquares.create(A, b, reg, alpha1=a1, alpha2=a2,
                                        dtype=torch.float64, device="cpu")


# ---------------------------------------------------------------- sparse


def test_sparse_matches_the_dense_solve():
    A, b = _sparse_data()
    sp = _sp(A, b)
    dn = TP.LeastSquares.create(A, b, "lasso", 0.5, dtype=torch.float64, device="cpu")
    assert sp.A.layout == torch.sparse_csr and sp.At.layout == torch.sparse_csr
    L = float(sp.lipschitz())
    r_sp = TS.fista(sp, TS.FISTAConfig(max_iter=1000), L=L)
    r_dn = TS.fista(dn, TS.FISTAConfig(max_iter=1000), L=L)
    np.testing.assert_allclose(r_sp.x.numpy(), r_dn.x.numpy(), rtol=0, atol=X_ATOL)


def test_sparse_fista_matches_jax():
    A, b = _sparse_data(seed=1)
    sp = _sp(A, b, "elasticnet", 0.5, 0.2)
    jsp = JP.SparseLeastSquares.create(A, b, "elasticnet", alpha1=0.5, alpha2=0.2,
                                       dtype=jnp.float64)
    from fastoptsolver_tpu.solvers import FISTAConfig, fista

    L = float(np.linalg.eigvalsh(A.T @ A)[-1]) + 0.2
    rt = TS.fista(sp, TS.FISTAConfig(max_iter=300, adaptive_restart=True), L=L)
    rj = fista(jsp, FISTAConfig(max_iter=300, adaptive_restart=True), L=L)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=X_ATOL)
    x = torch.linspace(-1.0, 1.0, A.shape[1], dtype=torch.float64)
    np.testing.assert_allclose(float(sp.objective(x)), float(jsp.objective(jnp.asarray(x.numpy()))),
                               rtol=1e-13)


def test_sparse_lipschitz_matches_eigvalsh():
    A, b = _sparse_data()
    sp = _sp(A, b, "elasticnet", 0.5, 0.3)
    lmax = float(np.linalg.eigvalsh(A.T @ A)[-1])
    np.testing.assert_allclose(float(sp.lipschitz(n_iter=500, tol=1e-12)), lmax + 0.3, rtol=1e-6)
    from fastoptsolver_tpu_torch.ops import lipschitz_for

    # lipschitz_for takes the operator too: A is never densified
    np.testing.assert_allclose(float(lipschitz_for(sp, n_iter=500, tol=1e-12)), lmax + 0.3,
                               rtol=1e-6)


def test_sparse_to_gram_and_cd():
    A, b = _sparse_data()
    sp = _sp(A, b, "elasticnet", 0.5, 0.2)
    g = sp.to_gram()
    np.testing.assert_allclose(g.Q.numpy(), A.T @ A, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.c.numpy(), A.T @ b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(g.btb), b @ b, rtol=1e-14)
    x_star, f_star = TS.certified_optimum(g, TS.CDConfig(max_sweeps=50000, tol=1e-15))
    np.testing.assert_allclose(float(sp.objective(x_star)), float(f_star), rtol=1e-12)
    # OWL-QN on the sparse problem reaches the same optimum
    sp1 = _sp(A, b, "lasso", 1.0)
    res = TS.owlqn(sp1, TS.OWLQNConfig(max_iter=500, tol=1e-10))
    _, f1 = TS.certified_optimum(sp1.to_gram(), TS.CDConfig(max_sweeps=50000, tol=1e-15))
    np.testing.assert_allclose(float(sp1.objective(res.x)), float(f1), rtol=1e-9)


def test_sparse_create_from_every_form():
    """Dense, scipy (duplicates summed), torch COO, CSR and CSC all give the
    same CSR matrix; density counts its stored entries."""
    A, b = _sparse_data()
    coo = ssp.coo_matrix(A)
    # split each entry in two: the duplicates must be summed
    dup = ssp.coo_matrix((np.concatenate([coo.data / 2, coo.data / 2]),
                          (np.concatenate([coo.row, coo.row]), np.concatenate([coo.col, coo.col]))),
                         shape=A.shape)
    At = torch.as_tensor(A)
    forms = [A, ssp.csr_matrix(A), dup, At.to_sparse(), At.to_sparse_csr(), At.to_sparse_csc()]
    for form in forms:
        sp = _sp(form, b)
        np.testing.assert_allclose(sp.A.to_dense().numpy(), A, rtol=0, atol=1e-15)
        np.testing.assert_allclose(sp.At.to_dense().numpy(), A.T, rtol=0, atol=1e-15)
        assert sp.nnz == np.count_nonzero(A)
    assert sp.density == pytest.approx(np.count_nonzero(A) / A.size)
    assert 0.0 < sp.density < 0.15
    assert _sp(A, b).A.dtype == torch.float64
    assert TP.SparseLeastSquares.create(A, b, device="cpu").A.dtype == torch.float32


def test_sparse_refuses_a_stack_and_follows_the_device_rule(monkeypatch):
    A, b = _sparse_data()
    with pytest.raises(ValueError, match="sparse"):
        stack_problems([_sp(A, b), _sp(A, b)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.SparseLeastSquares.create(ssp.csr_matrix(A), b)
    sp = TP.SparseLeastSquares.create(torch.as_tensor(A).to_sparse(), b)  # keeps its device
    assert sp.A.device.type == "cpu" and sp.b.device.type == "cpu"


# ---------------------------------------------------------------- boston


def test_synthetic_boston_is_the_references_bits():
    for seed, noise, std in ((0, 3.0, True), (5, 1.0, False)):
        got = TP.synthetic_boston(seed=seed, noise_std=noise, standardize=std)
        want = JP.synthetic_boston(seed=seed, noise_std=noise, standardize=std)
        for g, w in zip(got, want):
            assert g.dtype == np.float64 and np.array_equal(g, w)
    assert got[0].shape == (506, 13)


def test_load_boston_csv(tmp_path):
    from fastoptsolver_tpu_torch.problems import boston

    A, b, _ = boston.synthetic_boston(seed=1, standardize=False)
    path = tmp_path / "boston.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(boston.COLUMNS + [boston.TARGET])
        w.writerows(np.column_stack([A, b]).tolist())
    for std in (True, False):
        got = TP.load_boston_csv(str(path), standardize=std)
        want = JP.load_boston_csv(str(path), standardize=std)
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_)
    np.testing.assert_allclose(TP.load_boston_csv(str(path), standardize=False)[0], A,
                               rtol=1e-15)
    bad = tmp_path / "bad.csv"
    bad.write_text("CRIM,ZN\n1,2\n")
    with pytest.raises(ValueError, match="missing columns"):
        TP.load_boston_csv(str(bad))


# ---------------------------------------------------------------- genlasso


CFG = dict(abstol=1e-9, reltol=1e-9, max_iter=20000)


def _rand_problem(m=40, n=8, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_true = np.where(rng.random(n) < 0.5, 0.0, rng.normal(size=n))
    b = A @ x_true + 0.1 * rng.normal(size=m)
    return A, b


def _hold_jax(rt, rj):
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=0, atol=X_ATOL)
    assert int(rt.n_iters) == int(rj.n_iters)
    assert bool(rt.converged) == bool(rj.converged)


@pytest.mark.parametrize("reg", ["lasso", "elasticnet"])
def test_identity_D_is_the_lasso_and_matches_jax(reg):
    A, b = _rand_problem(seed=0 if reg == "lasso" else 3)
    a1, a2 = (3.0, 0.0) if reg == "lasso" else (2.0, 1.5)
    D = np.eye(A.shape[1])
    rt = TS.gen_lasso(A, b, D, alpha1=a1, alpha2=a2, config=TS.GenLassoConfig(**CFG),
                      dtype=torch.float64, device="cpu")
    rj = JG.gen_lasso(A, b, D, alpha1=a1, alpha2=a2, config=JG.GenLassoConfig(**CFG),
                      dtype=jnp.float64)
    assert bool(rt.converged)
    _hold_jax(rt, rj)
    p = TP.LeastSquares.create(A, b, reg, a1, a2, dtype=torch.float64, device="cpu")
    x_star, f_star = TS.certified_optimum(p)
    np.testing.assert_allclose(rt.x.numpy(), x_star.numpy(), atol=1e-5)
    f = objective_np(rt.x.numpy(), A, b, a1, a2)
    assert f <= float(f_star) + 1e-7 * max(1.0, abs(float(f_star)))
    np.testing.assert_allclose(float(rt.objective(A, b, D, a1, a2)), f, rtol=1e-12)


def test_tv_denoise_matches_jax_and_the_dual_oracle():
    rng = np.random.default_rng(1)
    y = np.concatenate([np.full(20, 1.0), np.full(20, -2.0), np.full(20, 0.5)])
    y = y + 0.3 * rng.normal(size=60)
    rt = TS.tv_denoise(y, 2.0, config=TS.GenLassoConfig(**CFG), dtype=torch.float64,
                       device="cpu")
    rj = JG.tv_denoise(y, 2.0, config=JG.GenLassoConfig(**CFG), dtype=jnp.float64)
    assert bool(rt.converged)
    _hold_jax(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), tv1d_np(y, 2.0), atol=1e-6)
    assert int((rt.z.abs() < 1e-12).sum()) > 40  # piecewise constant


def test_trend_filter_matches_jax_and_kkt():
    rng = np.random.default_rng(2)
    n = 50
    t = np.arange(n, dtype=np.float64)
    y = np.where(t < 25, 0.3 * t, 0.3 * 25 - 0.5 * (t - 25)) + 0.2 * rng.normal(size=n)
    lam = 10.0
    rt = TS.trend_filter(y, lam, order=2, config=TS.GenLassoConfig(**CFG),
                         dtype=torch.float64, device="cpu")
    rj = JG.trend_filter(y, lam, order=2, config=JG.GenLassoConfig(**CFG), dtype=jnp.float64)
    assert bool(rt.converged)
    _hold_jax(rt, rj)
    x = rt.x.numpy()
    D = TS.difference_matrix(n, 2, np.float64)
    np.testing.assert_array_equal(D, JG.difference_matrix(n, 2, np.float64))
    s = np.linalg.pinv(D.T) @ (y - x) / lam
    assert np.abs(s).max() <= 1.0 + 1e-5
    active = np.abs(D @ x) > 1e-6
    assert active.sum() >= 1
    np.testing.assert_allclose(s[active], np.sign((D @ x)[active]), atol=1e-5)


def test_fused_lasso_matches_jax_and_the_prox_composition():
    """A = I: argmin ½‖x−y‖² + λf·TV(x) + λs·‖x‖₁ = soft_threshold(prox_TV(y,
    λf), λs) (Friedman et al. 2007, Prop. 1); a strong fusion goes constant."""
    rng = np.random.default_rng(4)
    y = np.concatenate([np.full(15, 2.0), np.full(15, 0.2), np.full(15, -1.5)])
    y = y + 0.25 * rng.normal(size=45)
    rt = TS.fused_lasso(np.eye(45), y, alpha_fuse=1.5, alpha_sparse=0.3,
                        config=TS.GenLassoConfig(**CFG), dtype=torch.float64, device="cpu")
    rj = JG.fused_lasso(np.eye(45), y, alpha_fuse=1.5, alpha_sparse=0.3,
                        config=JG.GenLassoConfig(**CFG), dtype=jnp.float64)
    _hold_jax(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), shrink(tv1d_np(y, 1.5), 0.3), atol=1e-6)
    A, b = _rand_problem(m=30, n=6, seed=5)
    x = TS.fused_lasso(A, b, alpha_fuse=1e4, config=TS.GenLassoConfig(**CFG),
                       dtype=torch.float64, device="cpu").x.numpy()
    assert np.ptp(x) < 1e-4


def test_gen_lasso_takes_a_stack():
    """Stacked (A, b, D) with a leading batch axis, and a shared A and D with
    stacked b: every lane is its single solve, each stopping on its own."""
    rng = np.random.default_rng(6)
    cfg = TS.GenLassoConfig(abstol=1e-10, reltol=1e-10, max_iter=4000)
    As = rng.normal(size=(4, 30, 6))
    Bs = rng.normal(size=(4, 30))
    Ds = np.stack([TS.difference_matrix(6, 1 + (i % 2), np.float64)[:4] for i in range(4)])
    for A, D in ((As, Ds), (As[0], Ds[0])):
        batched = TS.gen_lasso(A, Bs, D, alpha1=1.0, config=cfg, dtype=torch.float64,
                               device="cpu")
        assert batched.x.shape == (4, 6) and batched.n_iters.shape == (4,)
        for i in range(4):
            Ai, Di = (A[i], D[i]) if A.ndim == 3 else (A, D)
            single = TS.gen_lasso(Ai, Bs[i], Di, alpha1=1.0, config=cfg, dtype=torch.float64,
                                  device="cpu")
            np.testing.assert_allclose(batched.x[i].numpy(), single.x.numpy(), rtol=0,
                                       atol=1e-10)
            assert int(batched.n_iters[i]) == int(single.n_iters)
            np.testing.assert_allclose(float(batched.objective(A, Bs, D, 1.0)[i]),
                                       float(single.objective(Ai, Bs[i], Di, 1.0)), rtol=1e-12)
        assert len(set(batched.n_iters.tolist())) > 1  # each lane stops on its own
