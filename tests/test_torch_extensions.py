"""The port's composite problem families (``fastoptsolver_tpu_torch.problems.
extensions``) and the solvers on a matrix iterate, against the JAX package,
float64 on both sides.

Each family's pieces (value, gradient, their joint form, prox, the nonsmooth
value, objective, ``x0`` and ``normal_matvec``) are the same formulas in both
packages: held to 1e-12 relative. Solves hand both packages the same L, so
the iterates are the same recurrence and differ only by the order of float64
sums: held to 1e-10 absolute (x is O(1)), iteration counts equal. Armijo runs
stop before the sufficient-decrease test comes down to the last bits, as in
``test_torch_solvers.py``. Each family makes one
JAX compile for its pieces (one jitted function) and one for its solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu import problems as JP
from fastoptsolver_tpu import solvers as JS
from fastoptsolver_tpu_torch import problems as TP
from fastoptsolver_tpu_torch import solvers as TS

torch.set_num_threads(1)

X_ATOL = 1e-10  # solves: the same recurrence, float64 sums in other orders
PIECE_RTOL = 1e-12  # the same formula on the same point
M, N, T = 60, 12, 3


def _data(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N))
    x_true = np.where(rng.random(N) < 0.4, rng.normal(size=N) * 2.0, 0.0)
    b = A @ x_true + 0.3 * rng.normal(size=M)
    return rng, A, b


def _lam_max(A, w=None):
    Aw = A if w is None else A * w[:, None]
    return float(np.linalg.eigvalsh(A.T @ Aw)[-1])


def _families():
    """name → (class name, create arguments, create keywords, L)."""
    rng, A, b = _data()
    lam = _lam_max(A)
    w = rng.uniform(0.5, 2.0, size=M)
    B = A @ (rng.normal(size=(N, T)) * (rng.random(N) < 0.5)[:, None]) + 0.2 * rng.normal(size=(M, T))
    A_p = 0.2 * A
    counts = rng.poisson(np.exp(A_p @ (rng.normal(size=N) * 0.5))).astype(np.float64)
    lo = np.linspace(-1.0, 0.2, N)  # x0 clips to the positive lower bounds
    return {
        "nnls": ("NonNegativeLeastSquares", (A, b), dict(alpha1=0.3, alpha2=0.2), lam + 0.2),
        "group": ("GroupLassoLeastSquares", (A, b), dict(alpha_g=2.0, group_size=3), lam),
        "box": ("BoxConstrainedLeastSquares", (A, b), dict(lower=lo, upper=0.8), lam),
        "multitask": ("MultiTaskLeastSquares", (A, B), dict(alpha1=2.0, alpha2=0.1), lam + 0.1),
        "quantile": ("QuantileRegression", (A, b),
                     dict(tau=0.3, mu=0.1, alpha1=0.5, alpha2=0.1), lam / 0.1 + 0.1),
        "poisson": ("PoissonRegression", (A_p, counts), dict(alpha1=0.5, alpha2=0.1),
                    _lam_max(A_p) + 0.1),
        "slope": ("SlopeLeastSquares", (A, b),
                  dict(lam=np.sort(rng.uniform(0.5, 3.0, N))[::-1].copy()), lam),
        "weighted": ("WeightedLeastSquares", (A, b, w),
                     dict(reg_type="elasticnet", alpha1=0.5, alpha2=0.2), _lam_max(A, w) + 0.2),
        "huber": ("HuberRegression", (A, b), dict(delta=0.5, alpha1=0.5, alpha2=0.1), lam + 0.1),
    }


FAMILIES = _families()


def _pair(name):
    cls, args, kw, L = FAMILIES[name]
    jp = getattr(JP, cls).create(*args, **kw, dtype=jnp.float64)
    tp = getattr(TP, cls).create(*args, **kw, dtype=torch.float64, device="cpu")
    return jp, tp, L


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_pieces_match_jax(name):
    jp, tp, _ = _pair(name)
    rng = np.random.default_rng(1)
    shape = tuple(tp.x0().shape)
    x, v = rng.normal(size=shape), rng.normal(size=shape)
    if name == "poisson":
        x = 0.3 * x  # keep exp(Ax) moderate
    if name == "nnls":
        x = np.abs(x)  # h is the L1 value on the feasible set

    def pieces(p, x, v):
        out = [p.smooth_value(x), p.smooth_grad(x), *p.smooth_value_and_grad(x),
               p.prox(v, 0.1), p.nonsmooth_value(x), p.objective(x), p.x0()]
        if hasattr(p, "normal_matvec"):
            out.append(p.normal_matvec(v))
        return out

    got = pieces(tp, torch.as_tensor(x), torch.as_tensor(v))
    want = jax.jit(pieces)(jp, jnp.asarray(x), jnp.asarray(v))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=PIECE_RTOL, atol=1e-13,
                                   err_msg=f"{name} piece {i}")
    assert tp.dim == jp.dim


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_solve_matches_jax(name):
    """One solve per family with the same L: fista (for Poisson Armijo from
    4/L, 5 iterations: at the sixth x⁺ ≈ y and the last bits decide a run of
    ~44 trials, in either package), ista for the quantile loss; x per 1e-10,
    counters equal."""
    jp, tp, L = _pair(name)
    if name == "poisson":
        kw = dict(max_iter=5, backtracking=True, t_init_factor=4.0)
    else:
        kw = dict(max_iter=150, adaptive_restart=name in ("group", "slope"))
    if name == "quantile":
        kw.pop("adaptive_restart")
        rt = TS.ista(tp, TS.ISTAConfig(**kw), L=L)
        rj = JS.ista(jp, JS.ISTAConfig(**kw), L=L)
    else:
        rt = TS.fista(tp, TS.FISTAConfig(**kw), L=L)
        rj = JS.fista(jp, JS.FISTAConfig(**kw), L=L)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=X_ATOL)
    assert int(rt.n_iters) == int(rj.n_iters)
    assert [int(v) for v in rt.metrics] == [int(v) for v in rj.metrics]
    np.testing.assert_allclose(float(rt.final_tau), float(rj.final_tau), rtol=1e-15)


# ---------------------------------------------------------------- matrix iterates


MODES = {
    "nesterov": dict(max_iter=200),
    "delta": dict(max_iter=200, momentum="delta", delta=4.0),
    "restart": dict(max_iter=200, adaptive_restart=True, tol_ratio=1e-6),
    "armijo": dict(max_iter=8, backtracking=True, t_init_factor=4.0),
    "tol": dict(max_iter=2000, tol=1e-7),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_multitask_fista_matches_jax(mode):
    """``MultiTaskLeastSquares`` (an (n, T) iterate) through the port's
    ``fista`` against JAX's: the solvers take the iterate whole, as
    ``jnp.vdot`` and the Frobenius norm do."""
    jp, tp, L = _pair("multitask")
    rt = TS.fista(tp, TS.FISTAConfig(**MODES[mode]), L=L)
    rj = JS.fista(jp, JS.FISTAConfig(**MODES[mode]), L=L)
    assert rt.x.shape == (N, T)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=X_ATOL)
    assert int(rt.n_iters) == int(rj.n_iters)
    assert [int(v) for v in rt.metrics] == [int(v) for v in rj.metrics]


def test_multitask_history_and_ista_match_jax():
    jp, tp, L = _pair("multitask")
    ht = TS.fista_with_history(tp, TS.FISTAConfig(max_iter=30), L=L).history
    hj = JS.fista_with_history(jp, JS.FISTAConfig(max_iter=30), L=L).history
    assert ht.x.shape == (30, N, T)
    np.testing.assert_allclose(ht.x.numpy(), np.asarray(hj.x), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(ht.obj.numpy(), np.asarray(hj.obj), rtol=PIECE_RTOL)
    np.testing.assert_allclose(ht.step_norm.numpy(), np.asarray(hj.step_norm), rtol=1e-10)
    cfg = dict(max_iter=300, tol=1e-8)
    rt = TS.ista(tp, TS.ISTAConfig(**cfg), L=L)
    rj = JS.ista(jp, JS.ISTAConfig(**cfg), L=L)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=X_ATOL)
    assert int(rt.n_iters) == int(rj.n_iters)


def test_multitask_fista_kkt():
    """``tests/test_multitask.py::test_matrix_fista_kkt`` on the port: active
    rows satisfy A_jᵀR = −α·x_j/‖x_j‖, inactive rows ‖A_jᵀR‖ ≤ α."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(150, 12))
    W = np.zeros((12, 4))
    W[0] = rng.normal(size=4) + 2.0
    W[3] = rng.normal(size=4) - 1.5
    W[7] = rng.normal(size=4) * 0.5 + 1.0
    B = A @ W + 0.05 * rng.normal(size=(150, 4))
    alpha = 8.0
    p = TP.MultiTaskLeastSquares.create(A, B, alpha1=alpha, dtype=torch.float64, device="cpu")
    res = TS.fista(p, TS.FISTAConfig(max_iter=6000))
    X = res.x.numpy()
    G = p.smooth_grad(res.x).numpy()
    row_norms = np.linalg.norm(X, axis=1)
    assert (row_norms > 1e-8).sum() >= 3
    for j in range(X.shape[0]):
        if row_norms[j] > 1e-8:
            np.testing.assert_allclose(G[j], -alpha * X[j] / row_norms[j], atol=1e-6)
        else:
            assert np.linalg.norm(G[j]) <= alpha + 1e-6


# ---------------------------------------------------------------- construction


def test_slope_lambda_bh_matches_jax():
    np.testing.assert_allclose(TP.slope_lambda_bh(40, q=0.2, sigma=1.5, dtype=torch.float64,
                                                  device="cpu").numpy(),
                               np.asarray(JP.slope_lambda_bh(40, q=0.2, sigma=1.5,
                                                             dtype=jnp.float64)),
                               rtol=1e-13)
    lam = TP.slope_lambda_bh(5, device="cpu")
    assert lam.dtype == torch.get_default_dtype()
    assert bool((lam[1:] <= lam[:-1]).all())


def test_constructor_guards():
    _, A, b = _data()
    with pytest.raises(ValueError, match="divisible"):
        TP.GroupLassoLeastSquares.create(A, b, 1.0, group_size=5, device="cpu")
    with pytest.raises(ValueError, match="non-increasing"):
        TP.SlopeLeastSquares.create(A, b, np.arange(N, dtype=float), device="cpu")
    with pytest.raises(ValueError, match="tau"):
        TP.QuantileRegression.create(A, b, tau=1.0, device="cpu")
    with pytest.raises(ValueError, match="mu"):
        TP.QuantileRegression.create(A, b, mu=0.0, device="cpu")
    with pytest.raises(ValueError, match="n_tasks"):
        TP.MultiTaskLeastSquares.create(A, b, device="cpu")
    p = TP.GroupLassoLeastSquares.create(A, b, 1.0, group_size=4, device="cpu")
    assert p.group_size == 4 and isinstance(p.group_size, int)


def test_weighted_to_gram_matches_jax():
    jp, tp, _ = _pair("weighted")
    gt, gj = tp.to_gram(), jp.to_gram()
    assert type(gt).__name__ == "GramLeastSquares"
    for f in ("Q", "c", "btb", "alpha1", "alpha2"):
        np.testing.assert_allclose(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                   rtol=1e-13, err_msg=f)
    x = torch.linspace(-1.0, 1.0, N, dtype=torch.float64)
    np.testing.assert_allclose(float(gt.objective(x)), float(tp.objective(x)), rtol=1e-12)


def test_lipschitz_for_takes_the_weighted_operator():
    """``lipschitz_for`` power-iterates ``normal_matvec`` where a family has
    one: the weighted λ, not the unweighted one."""
    from fastoptsolver_tpu_torch.ops import lipschitz_for

    _, tp, L = _pair("weighted")
    got = float(lipschitz_for(tp, n_iter=500, tol=1e-12))
    assert got == pytest.approx(L, rel=1e-8)


def test_create_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, A, b = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.NonNegativeLeastSquares.create(A, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.slope_lambda_bh(4)
    p = TP.HuberRegression.create(torch.as_tensor(A), b)  # a tensor keeps its device
    assert p.A.device.type == "cpu" and p.b.device.type == "cpu"
    p = TP.MultiTaskLeastSquares.create(A, np.ones((M, 2)), device="cpu")
    assert p.B.device.type == "cpu" and p.x0().shape == (N, 2)
