"""The port's prox-gradient solvers, coordinate descent and ADMM
(``fastoptsolver_tpu_torch.solvers.{common,ista,fista,cd,admm}``) against the
JAX package's and the NumPy oracle, float64 on every side.

Every trajectory test hands both packages the same L (``power_L`` from a
ones start vector), so the iterates are the same recurrence and differ only
by the order of float64 sums: iterates are held per iteration to 1e-10
absolute (the problems' x are O(1)), objectives to 1e-12 relative, and the
``Metrics`` counters and iteration counts equal. FISTA's Armijo runs stop at
8 iterations: from iteration 10-25 on these problems the sufficient-decrease
test is decided by the last bits (x⁺ ≈ y), a rejection can land on either
side in either package, and τ, which never grows back, then parts the two
runs (in the reference against itself too, SURVEY.md §7's Armijo stall).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu import solvers as JS
from fastoptsolver_tpu.problems import LeastSquares as JLS, generate_boston_like
from fastoptsolver_tpu_torch import solvers as TS
from fastoptsolver_tpu_torch.problems import LeastSquares
from fastoptsolver_tpu.solvers.cd import cd_sweep as j_sweep
from fastoptsolver_tpu_torch.solvers.admm import quadratic_data
from fastoptsolver_tpu_torch.solvers.cd import cd_sweep
from fastoptsolver_tpu_torch.solvers.common import (
    LineSearchConfig,
    Run,
    armijo_prox_search,
    run_loop,
    tree_where,
)
from oracle_np import fista_np, ista_np, objective_np, power_L

torch.set_num_threads(1)

X_ATOL = 1e-10  # per-iteration iterate agreement, float64, O(1) iterates
OBJ_RTOL = 1e-12  # objectives of the same iterates


def _data(seed=0, m=200):
    A, b, _ = generate_boston_like(m=m, seed=seed, noise_std=1.0, rho1=0.5, rho2=0.7)
    return (A - A.mean(0)) / A.std(0), b


def _pair(reg="lasso", a1=0.5, a2=0.0, seed=0, m=200):
    """(port problem, JAX problem, A, b, α₁ eff, α₂ eff, L) on one dataset."""
    A, b = _data(seed, m)
    tp = LeastSquares.create(A, b, reg, a1, a2, dtype=torch.float64, device="cpu")
    jp = JLS.create(A, b, reg, a1, a2, dtype=jnp.float64)
    L = power_L(A, np.ones(A.shape[1])) + float(tp.alpha2)
    return tp, jp, A, b, float(tp.alpha1), float(tp.alpha2), L


def _metrics(res):
    return [int(v) for v in res.metrics]


def _hold_history(rt, rj):
    np.testing.assert_allclose(rt.history.x.numpy(), np.asarray(rj.history.x), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(rt.history.obj.numpy(), np.asarray(rj.history.obj), rtol=OBJ_RTOL)
    np.testing.assert_array_equal(rt.history.valid.numpy(), np.asarray(rj.history.valid))
    np.testing.assert_allclose(rt.history.tau.numpy(), np.asarray(rj.history.tau), rtol=1e-15)
    assert int(rt.n_iters) == int(rj.n_iters)
    assert _metrics(rt) == _metrics(rj)


# ---------------------------------------------------------------- common


def test_tree_where_pads_a_lane_predicate():
    pred = torch.tensor([True, False])
    a = (torch.ones(2, 3), torch.ones(2))
    b = (torch.zeros(2, 3), torch.zeros(2))
    out = tree_where(pred, a, b)
    assert torch.equal(out[0], torch.tensor([[1.0] * 3, [0.0] * 3]))
    assert torch.equal(out[1], torch.tensor([1.0, 0.0]))


def test_run_loop_freezes_a_stopped_problem_and_reads_every_few_steps(monkeypatch):
    """Each problem stops at its own step and stays frozen through the steps
    the loop runs before its next read; no stop rule: every step runs."""
    reads = []
    real_any = torch.Tensor.any

    def counting_any(self, *a, **k):
        reads.append(1)
        return real_any(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "any", counting_any)
    stop_at = torch.tensor([3, 17])
    out = run_loop(lambda k: k + 1, torch.zeros(2, dtype=torch.int64), 100,
                   lambda k: k < stop_at)
    assert out.tolist() == [3, 17]
    assert len(reads) == 3  # steps 0, 10 and 20
    reads.clear()
    assert int(run_loop(lambda k: k + 1, torch.tensor(0), 7, None, stops=False)) == 7
    assert reads == []


def test_armijo_search_matches_jax():
    """The search from a step 8/L: the accepted x, τ and backtrack count."""
    tp, jp, A, b, a1, a2, L = _pair()
    y = np.linspace(-1.0, 1.0, A.shape[1])
    g_y, grad = tp.smooth_value_and_grad(torch.tensor(y))
    x_t, tau_t, k_t = armijo_prox_search(tp, torch.tensor(y), g_y, grad,
                                         torch.tensor(8.0 / L, dtype=torch.float64),
                                         LineSearchConfig(backtracking=True))
    from fastoptsolver_tpu.solvers.common import LineSearchConfig as JL, armijo_prox_search as ja

    jg, jgrad = jp.smooth_value_and_grad(jnp.asarray(y))
    x_j, tau_j, k_j = ja(jp, jnp.asarray(y), jg, jgrad, jnp.asarray(8.0 / L),
                         JL(backtracking=True))
    assert int(k_t) == int(k_j) > 0
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-15)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=X_ATOL)


def test_run_batched_pieces_equal_the_single_calls():
    """``Run(batched=True)`` vmaps a piece over a stack: each lane equals the
    piece on its own problem."""
    from fastoptsolver_tpu_torch.batch import stack_problems

    probs = [_pair(seed=s)[0] for s in range(3)]
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    got = Run(stack_problems(probs), batched=True)(lambda p, z, t: p.prox(z, t), x,
                                                   torch.tensor([0.1, 0.2, 0.3]))
    for i, p in enumerate(probs):
        assert torch.equal(got[i], p.prox(x[i], torch.tensor([0.1, 0.2, 0.3])[i]))


# ---------------------------------------------------------------- ista


ISTA_MODES = {
    "fixed": dict(max_iter=50),
    "armijo": dict(max_iter=20, backtracking=True, t_init_factor=4.0),
    "step_tol": dict(max_iter=500, tol=1e-5),
}


@pytest.mark.parametrize("reg", ["lasso", "elasticnet", "ridge"])
@pytest.mark.parametrize("mode", list(ISTA_MODES))
def test_ista_matches_jax_and_the_oracle(reg, mode):
    tp, jp, A, b, a1, a2, L = _pair(reg, 0.5, 0.8)
    kw = ISTA_MODES[mode]
    rt = TS.ista_with_history(tp, TS.ISTAConfig(**kw), L=L)
    rj = JS.ista_with_history(jp, JS.ISTAConfig(**kw), L=jnp.asarray(L))
    _hold_history(rt, rj)
    x_ref, tr = ista_np(A, b, a1, a2, L, **kw)
    k = int(rt.n_iters)
    assert k == len(tr["step"])
    np.testing.assert_allclose(rt.history.x.numpy()[:k], np.asarray(tr["x"][1:]), atol=X_ATOL)
    # the loop without history: the same x, counts and iterations
    rs = TS.ista(tp, TS.ISTAConfig(**kw), L=L)
    np.testing.assert_allclose(rs.x.numpy(), rt.x.numpy(), rtol=0, atol=1e-14)
    assert int(rs.n_iters) == k and _metrics(rs) == _metrics(rt)
    if mode == "step_tol":
        assert k < 500 and not bool(rt.history.valid[k])


# ---------------------------------------------------------------- fista


FISTA_MODES = {
    "nesterov": dict(max_iter=60),
    "armijo": dict(max_iter=8, backtracking=True),
    "armijo_t2": dict(max_iter=8, backtracking=True, t_init_factor=2.0),
    "restart": dict(max_iter=80, adaptive_restart=True),
    "restart_armijo": dict(max_iter=8, adaptive_restart=True, backtracking=True,
                           t_init_factor=2.0),
    "step_tol": dict(max_iter=400, tol=1e-6),
    "ratio_tol": dict(max_iter=400, tol_ratio=0.5),
}


@pytest.mark.parametrize("reg", ["lasso", "elasticnet", "ridge"])
@pytest.mark.parametrize("mode", list(FISTA_MODES))
def test_fista_matches_jax_and_the_oracle(reg, mode):
    tp, jp, A, b, a1, a2, L = _pair(reg, 0.5, 0.8)
    kw = FISTA_MODES[mode]
    rt = TS.fista_with_history(tp, TS.FISTAConfig(**kw), L=L)
    rj = JS.fista_with_history(jp, JS.FISTAConfig(**kw), L=jnp.asarray(L))
    _hold_history(rt, rj)
    x_ref, tr = fista_np(A, b, a1, a2, L, **kw)
    k = int(rt.n_iters)
    assert k == tr["n_iters"]
    np.testing.assert_allclose(rt.x.numpy(), x_ref, atol=X_ATOL)
    np.testing.assert_allclose(rt.history.obj.numpy()[:k], tr["obj"], rtol=OBJ_RTOL)
    rs = TS.fista(tp, TS.FISTAConfig(**kw), L=L)
    np.testing.assert_allclose(rs.x.numpy(), rt.x.numpy(), rtol=0, atol=1e-14)
    assert int(rs.n_iters) == k and _metrics(rs) == _metrics(rt)
    if mode in ("step_tol", "ratio_tol"):
        assert k < 400


@pytest.mark.parametrize("delta", [2.5, 4.0, 10.0])
def test_fista_delta_matches_jax_and_the_oracle(delta):
    tp, jp, A, b, a1, a2, L = _pair()
    rt = TS.fista_with_history(tp, TS.fista_delta_config(delta, max_iter=60), L=L)
    rj = JS.fista_with_history(jp, JS.fista_delta_config(delta, max_iter=60), L=jnp.asarray(L))
    _hold_history(rt, rj)
    x_ref, tr = fista_np(A, b, a1, a2, L, max_iter=60, delta=delta)
    np.testing.assert_allclose(rt.x.numpy(), x_ref, atol=X_ATOL)


def test_fista_grad_norm_stop_freezes_before_the_update():
    """The gradient-norm rule fires before the prox update: the stopping
    iteration is not counted and its history row is not valid, as JAX's. A
    is scaled so that τ = 1/L > 1 and the gradient falls below ``tol``
    before the step does."""
    A, b = _data()
    A = 0.05 * A
    tp = LeastSquares.create(A, b, "ridge", 0.0, 0.01, dtype=torch.float64, device="cpu")
    jp = JLS.create(A, b, "ridge", 0.0, 0.01, dtype=jnp.float64)
    L = power_L(A, np.ones(5)) + 0.01
    cfg = dict(max_iter=400, tol=1e-4)
    rt = TS.fista_with_history(tp, TS.FISTAConfig(**cfg), L=L)
    rj = JS.fista_with_history(jp, JS.FISTAConfig(**cfg), L=jnp.asarray(L))
    _hold_history(rt, rj)
    k = int(rt.n_iters)
    assert k < 400 and int(rt.metrics.n_grad_evals) == k + 1
    assert bool(rt.history.valid[k - 1]) and not bool(rt.history.valid[k])


def test_fista_config_guards():
    with pytest.raises(ValueError):
        TS.FISTAConfig(momentum="bogus")
    with pytest.raises(ValueError):
        TS.fista_delta_config(2.0)
    assert TS.fista_delta_config(3.0).momentum == "delta"


def test_fista_step_is_the_loops_step():
    """The public ``fista_step`` advances the state as the loop does."""
    from fastoptsolver_tpu_torch.solvers.common import Metrics
    from fastoptsolver_tpu_torch.solvers.fista import init_state

    tp, jp, A, b, a1, a2, L = _pair()
    cfg = TS.FISTAConfig(max_iter=5)
    s, m = init_state(tp, cfg, None, 1.0 / L), Metrics.zero()
    for _ in range(5):
        s, m, x_next, applied = TS.fista_step(tp, cfg, s, m)
        assert bool(applied) and torch.equal(x_next, s.x)
    assert torch.equal(s.x, TS.fista(tp, cfg, L=L).x) and int(m.n_grad_evals) == 5


def test_fista_estimates_L_from_a_generator():
    """Without ``L`` the solver runs the power iteration from the generator's
    start vector: the same generator seed gives the same bits, and L is
    λ_max(AᵀA) + α₂ to the loop's tolerance."""
    tp, jp, A, b, a1, a2, L = _pair("elasticnet", 0.5, 0.8)
    r1 = TS.fista(tp, TS.FISTAConfig(max_iter=30), generator=torch.Generator().manual_seed(3))
    r2 = TS.fista(tp, TS.FISTAConfig(max_iter=30), generator=torch.Generator().manual_seed(3))
    assert torch.equal(r1.x, r2.x)
    lam = float(np.linalg.eigvalsh(A.T @ A)[-1]) + 0.8
    np.testing.assert_allclose(float(r1.L), lam, rtol=1e-6)


# ---------------------------------------------------------------- cd / admm


@pytest.mark.parametrize("reg,a1,a2", [("lasso", 0.5, 0.0), ("elasticnet", 0.5, 0.8),
                                       ("ridge", 0.0, 0.8)])
def test_cd_and_certified_optimum_match_jax(reg, a1, a2):
    """Sweeps, x and f* against JAX's CD on the Gram form, and the optimum
    itself: ridge against the closed form, lasso against its KKT conditions
    (|∇g_j| = α₁ on the support, ≤ α₁ off it)."""
    tp, jp, A, b, ea1, ea2, L = _pair(reg, a1, a2)
    cfg = dict(tol=1e-14)
    rt = TS.cd(tp, TS.CDConfig(**cfg))
    rj = JS.cd(jp, JS.CDConfig(**cfg))
    assert int(rt.n_iters) == int(rj.n_iters) and _metrics(rt) == _metrics(rj)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-12)
    xt, ft = TS.certified_optimum(tp.to_gram())
    xj, fj = JS.certified_optimum(jp.to_gram())
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-13)
    np.testing.assert_allclose(float(ft), objective_np(xt.numpy(), A, b, ea1, ea2), rtol=1e-12)
    g = A.T @ (A @ xt.numpy() - b) + ea2 * xt.numpy()
    if reg == "ridge":
        np.testing.assert_allclose(xt.numpy(), np.linalg.solve(A.T @ A + ea2 * np.eye(5), A.T @ b),
                                   rtol=1e-10)
    else:
        on = xt.numpy() != 0
        np.testing.assert_allclose(np.abs(g[on]), ea1, rtol=1e-9)
        assert np.all(np.abs(g[~on]) <= ea1 + 1e-9)


def test_cd_sweep_matches_jax():
    tp, jp, *_ = _pair("elasticnet", 0.5, 0.8)
    gt, gj = tp.to_gram(), jp.to_gram()
    x = np.linspace(-1, 1, 5)
    got = cd_sweep(gt.Q, gt.c, gt.alpha1, gt.alpha2, torch.tensor(x))

    want = j_sweep(gj.Q, gj.c, gj.alpha1, gj.alpha2, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-13)


ADMM_CASES = {
    "lasso": (("lasso", 0.5, 0.0), {}),
    "enet_overrelaxed": (("elasticnet", 0.5, 0.8), dict(over_relaxation=1.6)),
    "fixed_rho": (("lasso", 0.5, 0.0), dict(adaptive_rho=False, rho=50.0, max_iter=300)),
    "bad_rho": (("lasso", 0.5, 0.0), dict(rho=1e-3, max_iter=2000)),
}


@pytest.mark.parametrize("case", list(ADMM_CASES))
@pytest.mark.parametrize("gram", [False, True])
def test_admm_matches_jax(case, gram):
    """x, ρ, iterations and the residuals against JAX's ADMM, on the dense
    and on the Gram form; the converged cases also against CD's optimum."""
    (reg, a1, a2), kw = ADMM_CASES[case]
    tp, jp, A, b, *_ = _pair(reg, a1, a2)
    if gram:
        tp, jp = tp.to_gram(), jp.to_gram()
    rt = TS.admm(tp, TS.ADMMConfig(**kw))
    rj = JS.admm(jp, JS.ADMMConfig(**kw))
    assert int(rt.n_iters) == int(rj.n_iters)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    np.testing.assert_allclose(rt.x_smooth.numpy(), np.asarray(rj.x_smooth), atol=1e-10)
    np.testing.assert_allclose(float(rt.rho), float(rj.rho), rtol=1e-15)
    np.testing.assert_allclose(float(rt.r_norm), float(rj.r_norm), rtol=1e-6, atol=1e-12)
    if bool(rt.converged):
        xs, fs = TS.certified_optimum(tp if gram else tp.to_gram())
        np.testing.assert_allclose(float(tp.objective(rt.x)), float(fs), rtol=1e-9)


def test_admm_quadratic_data_and_guard():
    tp, *_ = _pair("elasticnet", 0.5, 0.8)
    Q, c = quadratic_data(tp)
    A = tp.A
    torch.testing.assert_close(Q, A.T @ A + 0.8 * torch.eye(5, dtype=torch.float64))
    torch.testing.assert_close(c, A.T @ tp.b)
    with pytest.raises(TypeError):
        TS.admm(object())
