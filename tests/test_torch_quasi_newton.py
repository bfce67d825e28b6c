"""The port's quasi-Newton solvers (``fastoptsolver_tpu_torch.solvers.
{lbfgs,owlqn}``) against the JAX package's, SciPy and closed forms, float64.

Held:
- the two-loop direction against a dense BFGS inverse (rtol 1e-9) and
  against JAX's on a part-filled, wrapped ring (rtol 1e-12);
- the strong-Wolfe search against JAX's on a quadratic and a least-squares
  line (a, f, evaluations equal; a to 1e-12);
- ``lbfgs`` and ``owlqn`` against JAX: the final x to 1e-7, and the
  history, its length and valid rows with the default stop rules. Near the
  optimum the line searches compare float64 values whose sums run in
  another order, so where a run is driven to pgtol 1e-10 a decision there
  can end either package a few iterations apart: there the objectives are
  held to 1e-12 relative and each x against the closed form;
- L-BFGS ridge against ``numpy.linalg.solve`` (x to rtol 1e-6; JAX's own
  reaches the rtol 1e-4 its test holds) and against
  ``scipy.optimize.fmin_l_bfgs_b``'s objective (no worse by 1e-12
  relative); logistic regression against SciPy (objective rtol 1e-9);
- the reference's lasso quirk (the smooth part minimized, the full
  objective recorded), as ``tests/test_compat.py`` checks it;
- OWL-QN against CD's certified optimum (objective rtol 1e-10, x 1e-7) and
  its exact zeros.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import fmin_l_bfgs_b

from fastoptsolver_tpu import solvers as JS
from fastoptsolver_tpu.problems import (
    LeastSquares as JLS,
    LogisticRegression as JLR,
    generate_boston_like,
)
from fastoptsolver_tpu.solvers.lbfgs import (
    two_loop_direction as j_two_loop,
    wolfe_line_search as j_wolfe,
)
from fastoptsolver_tpu.solvers.owlqn import pseudo_gradient as j_pseudo
from fastoptsolver_tpu_torch import solvers as TS
from fastoptsolver_tpu_torch.problems import LeastSquares, LogisticRegression
from fastoptsolver_tpu_torch.solvers.lbfgs import two_loop_direction, wolfe_line_search
from fastoptsolver_tpu_torch.solvers.owlqn import pseudo_gradient

torch.set_num_threads(1)

X_ATOL = 1e-7  # final iterates of the two packages' quasi-Newton runs


def _ls(reg="ridge", a1=0.0, a2=0.5, seed=0, m=300):
    A, b, _ = generate_boston_like(m=m, seed=seed, noise_std=1.0, rho1=0.5, rho2=0.7)
    A = (A - A.mean(0)) / A.std(0)
    return (LeastSquares.create(A, b, reg, a1, a2, dtype=torch.float64, device="cpu"),
            JLS.create(A, b, reg, a1, a2, dtype=jnp.float64), A, b)


def _sparse(seed=0, m=200, n=20):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_true = np.zeros(n)
    x_true[: n // 4] = rng.normal(size=n // 4) * 3
    return A, A @ x_true + 0.1 * rng.normal(size=m)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


# ---------------------------------------------------------------- two loops


def test_two_loop_matches_dense_inverse_hessian():
    rng = np.random.default_rng(0)
    n, mem = 6, 8
    H = rng.normal(size=(n, n))
    H = H @ H.T + n * np.eye(n)
    S = rng.normal(size=(mem, n))
    Y = S @ H.T
    rho = 1.0 / np.einsum("ij,ij->i", S, Y)
    g = rng.normal(size=n)
    gamma = float(S[-1] @ Y[-1] / (Y[-1] @ Y[-1]))
    Hinv = gamma * np.eye(n)
    for s, y, r in zip(S, Y, rho):
        V = np.eye(n) - r * np.outer(y, s)
        Hinv = V.T @ Hinv @ V + r * np.outer(s, s)
    got = two_loop_direction(_t(g), _t(S), _t(Y), _t(rho), torch.tensor(mem),
                             torch.tensor(0), torch.tensor(gamma, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), -Hinv @ g, rtol=1e-9)


@pytest.mark.parametrize("count,head", [(0, 0), (3, 3), (5, 2), (7, 7), (7, 4)])
def test_two_loop_matches_jax_on_a_ring(count, head):
    """Part-filled and wrapped rings (memory 7): the newest pair is slot
    head − 1, the valid ones the ``count`` before it."""
    rng = np.random.default_rng(1)
    mem, n = 7, 5
    S, Y = rng.normal(size=(mem, n)), rng.normal(size=(mem, n))
    rho = 1.0 / np.abs(np.einsum("ij,ij->i", S, Y))
    g = rng.normal(size=n)
    got = two_loop_direction(_t(g), _t(S), _t(Y), _t(rho), torch.tensor(count),
                             torch.tensor(head), torch.tensor(0.7, dtype=torch.float64))
    want = j_two_loop(jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y), jnp.asarray(rho),
                      jnp.asarray(count, jnp.int32), jnp.asarray(head, jnp.int32),
                      jnp.asarray(0.7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    if count == 0:
        np.testing.assert_allclose(got.numpy(), -0.7 * g)


# ---------------------------------------------------------------- Wolfe search


class _Quad:
    def __init__(self, H, lib):
        self.H, self.lib = H, lib

    def smooth_value_and_grad(self, z):
        Hz = self.H @ z
        return 0.5 * (z @ Hz), Hz


@pytest.mark.parametrize("start", ["quadratic", "least_squares_far", "least_squares_near"])
def test_wolfe_line_search_matches_jax(start):
    """The bracket-then-zoom machine takes the same trials as JAX's and lands
    on a strong-Wolfe point: a unit step too long (zoom), and one too short
    (expansion)."""
    if start == "quadratic":
        H = np.diag([1.0, 10.0])
        pt, pj = _Quad(_t(H), torch), _Quad(jnp.asarray(H), jnp)
        x = np.array([1.0, 1.0])
        d = -(H @ x)
    else:
        pt, pj, A, b = _ls()
        x = np.zeros(5)
        g0 = A.T @ (A @ x - b) + 0.5 * x
        d = -g0 * (1e-4 if start == "least_squares_near" else 1.0)
    ft, gt = pt.smooth_value_and_grad(_t(x))
    fj, gj = pj.smooth_value_and_grad(jnp.asarray(x))
    cfg_t, cfg_j = TS.LBFGSConfig(), JS.LBFGSConfig()
    a, f, g, n_evals, ok = wolfe_line_search(pt, _t(x), ft, gt, _t(d), cfg_t)
    aj, fj2, gj2, nj, okj = j_wolfe(pj, jnp.asarray(x), fj, gj, jnp.asarray(d), cfg_j)
    assert bool(ok) and bool(okj) and int(n_evals) == int(nj)
    np.testing.assert_allclose(float(a), float(aj), rtol=1e-12)
    np.testing.assert_allclose(float(f), float(fj2), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj2), rtol=1e-9, atol=1e-9)
    dphi0 = float(gt @ _t(d))
    assert float(f) <= float(ft) + 1e-4 * float(a) * dphi0
    assert abs(float(g @ _t(d))) <= 0.9 * abs(dphi0)


# ---------------------------------------------------------------- lbfgs


@pytest.mark.parametrize("a2", [0.1, 1.0, 10.0])
def test_lbfgs_ridge_matches_jax_closed_form_and_scipy(a2):
    pt, pj, A, b = _ls(a2=a2)
    cfg = dict(tol=1e-10, ftol=1e-18)
    rt = TS.lbfgs(pt, TS.LBFGSConfig(**cfg))
    rj = JS.lbfgs(pj, JS.LBFGSConfig(**cfg))
    x_star = np.linalg.solve(A.T @ A + a2 * np.eye(5), A.T @ b)
    np.testing.assert_allclose(rt.x.numpy(), x_star, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rj.x), x_star, rtol=1e-4)  # JAX's own test's bar
    f_j = float(pj.smooth_value(rj.x))
    np.testing.assert_allclose(float(pt.smooth_value(rt.x)), f_j, rtol=1e-12)

    def fg(x):
        r = A @ x - b
        return 0.5 * r @ r + 0.5 * a2 * x @ x, A.T @ r + a2 * x

    _, f_sp, _ = fmin_l_bfgs_b(fg, np.zeros(5), pgtol=1e-10)
    f_t = float(pt.smooth_value(rt.x))
    assert f_t <= f_sp * (1 + 1e-12) + 1e-9
    assert f_t - fg(x_star)[0] <= 1e-12 * abs(fg(x_star)[0])


@pytest.mark.parametrize("reg,a1,a2,seed", [("ridge", 0.0, 0.5, 0), ("ridge", 0.0, 2.0, 1),
                                            ("lasso", 5.0, 0.0, 1)])
def test_lbfgs_history_matches_jax(reg, a1, a2, seed):
    """Default stop rules (pgtol 1e-6 and SciPy's factr): the iteration count,
    the valid rows, the recorded objectives and the counters as JAX's."""
    pt, pj, A, b = _ls(reg, a1, a2, seed=seed)
    rt = TS.lbfgs_with_history(pt, TS.LBFGSConfig(max_iter=60))
    rj = JS.lbfgs_with_history(pj, JS.LBFGSConfig(max_iter=60))
    assert int(rt.n_iters) == int(rj.n_iters) < 60
    np.testing.assert_array_equal(rt.history.valid.numpy(), np.asarray(rj.history.valid))
    np.testing.assert_allclose(rt.history.obj.numpy(), np.asarray(rj.history.obj), rtol=1e-12)
    np.testing.assert_allclose(rt.history.x.numpy(), np.asarray(rj.history.x), atol=X_ATOL)
    np.testing.assert_allclose(rt.history.step_norm.numpy(),
                               np.asarray(rj.history.step_norm), atol=X_ATOL)
    assert [int(v) for v in rt.metrics] == [int(v) for v in rj.metrics]
    rs = TS.lbfgs(pt, TS.LBFGSConfig(max_iter=60))
    assert int(rs.n_iters) == int(rt.n_iters) and torch.equal(rs.x, rt.x)


def test_lbfgs_lasso_quirk_minimizes_the_smooth_part_only():
    """The reference's lasso quirk: the solver ignores α₁, so x is the
    least-squares solution, while the history records the full objective."""
    pt, pj, A, b = _ls("lasso", 5.0, 0.0, seed=1, m=200)
    res = TS.lbfgs_with_history(pt, TS.LBFGSConfig(tol=1e-10, ftol=1e-18))
    np.testing.assert_allclose(res.x.numpy(), np.linalg.lstsq(A, b, rcond=None)[0], rtol=1e-5)
    k = int(res.n_iters) - 1
    want = float(pt.objective(res.x))
    np.testing.assert_allclose(float(res.history.obj[k]), want, rtol=1e-10)
    assert want > float(pt.smooth_value(res.x))


def test_lbfgs_logistic_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    m, n, a2 = 200, 8, 0.5
    A = rng.normal(size=(m, n))
    y = np.sign(A @ rng.normal(size=n) + 0.3 * rng.normal(size=m))
    pt = LogisticRegression.create(A, y, alpha2=a2, dtype=torch.float64, device="cpu")
    pj = JLR.create(A, y, alpha2=a2, dtype=jnp.float64)

    def fg(x):
        margins = y * (A @ x)
        return (np.logaddexp(0, -margins).sum() + 0.5 * a2 * x @ x,
                A.T @ (-y / (1 + np.exp(margins))) + a2 * x)

    x_sp, f_sp, _ = fmin_l_bfgs_b(fg, np.zeros(n), pgtol=1e-10)
    rt = TS.lbfgs(pt, TS.LBFGSConfig(tol=1e-10))
    rj = JS.lbfgs(pj, JS.LBFGSConfig(tol=1e-10))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=X_ATOL)
    np.testing.assert_allclose(float(pt.smooth_value(rt.x)), f_sp, rtol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), x_sp, rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------- owlqn


def test_pseudo_gradient_closed_form_and_jax():
    x = np.array([2.0, -3.0, 0.0, 0.0, 0.0])
    g = np.array([1.0, 1.0, -2.0, 2.0, 0.3])
    v = pseudo_gradient(_t(x), _t(g), torch.tensor(0.5, dtype=torch.float64))
    np.testing.assert_allclose(v.numpy(), [1.5, 0.5, -1.5, 1.5, 0.0])
    np.testing.assert_allclose(v.numpy(), np.asarray(j_pseudo(jnp.asarray(x), jnp.asarray(g),
                                                              jnp.asarray(0.5))))


@pytest.mark.parametrize("reg,a1,a2", [("lasso", 3.0, 0.0), ("lasso", 8.0, 0.0),
                                       ("elasticnet", 2.0, 1.0)])
def test_owlqn_matches_jax_and_the_cd_optimum(reg, a1, a2):
    A, b = _sparse()
    pt = LeastSquares.create(A, b, reg, a1, a2, dtype=torch.float64, device="cpu")
    pj = JLS.create(A, b, reg, a1, a2, dtype=jnp.float64)
    cfg = dict(max_iter=500, tol=1e-10)
    rt = TS.owlqn(pt, TS.OWLQNConfig(**cfg))
    rj = JS.owlqn(pj, JS.OWLQNConfig(**cfg))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=X_ATOL)
    x_star, f_star = TS.certified_optimum(pt.to_gram(), TS.CDConfig(max_sweeps=50000, tol=1e-15))
    np.testing.assert_allclose(float(pt.objective(rt.x)), float(f_star), rtol=1e-10)
    np.testing.assert_allclose(rt.x.numpy(), x_star.numpy(), atol=1e-7)
    # exact zeros where the optimum has them
    x = rt.x.numpy()
    assert set(np.flatnonzero(x == 0.0)) == set(np.flatnonzero(np.abs(x_star.numpy()) < 1e-10))


def test_owlqn_history_matches_jax():
    """A fixed 12 iterations (no stop rule fires): every row, the objective,
    the step norms and the counters as JAX's; the objective never rises."""
    A, b = _sparse()
    pt = LeastSquares.create(A, b, "lasso", 3.0, dtype=torch.float64, device="cpu")
    pj = JLS.create(A, b, "lasso", 3.0, dtype=jnp.float64)
    rt = TS.owlqn_with_history(pt, TS.OWLQNConfig(max_iter=12, tol=0.0))
    rj = JS.owlqn_with_history(pj, JS.OWLQNConfig(max_iter=12, tol=0.0))
    assert int(rt.n_iters) == int(rj.n_iters) == 12
    np.testing.assert_array_equal(rt.history.valid.numpy(), np.asarray(rj.history.valid))
    np.testing.assert_allclose(rt.history.x.numpy(), np.asarray(rj.history.x), atol=1e-9)
    np.testing.assert_allclose(rt.history.obj.numpy(), np.asarray(rj.history.obj), rtol=1e-12)
    assert [int(v) for v in rt.metrics] == [int(v) for v in rj.metrics]
    assert np.all(np.diff(rt.history.obj.numpy()) <= 1e-12)


def test_owlqn_beats_the_smooth_lbfgs_on_the_l1_objective():
    A, b = _sparse()
    p = LeastSquares.create(A, b, "lasso", 5.0, dtype=torch.float64, device="cpu")
    f_owl = float(p.objective(TS.owlqn(p, TS.OWLQNConfig(tol=1e-10)).x))
    f_smooth = float(p.objective(TS.lbfgs(p, TS.LBFGSConfig(tol=1e-10)).x))
    assert f_owl < f_smooth
