"""The port's one-call surfaces against the JAX package's: ``solve``,
``batch.{stack_problems,batch_lipschitz,solve_batch}``, the generators,
``compat`` and the large-lasso bench, on the CPU (``device="cpu"``).

Tolerances:
- ``solve``: float64, m = 200, n = 12. Where a method estimates L, the two
  packages start their power iterations from other vectors (a torch
  generator against ``jax.random``): the loop stops once |ΔL| < 1e-6, which
  leaves L within ~1e-5 of λ_max (1e-7 relative), history objectives held
  at rtol 1e-7, the converged iterates to 1e-9; the exact-L
  methods (cd, admm, lbfgs) to 1e-12; owlqn's last iterations part at the
  float64 floor (1e-7). svrg and saga draw other permutations: both
  packages are held to CD's f* (rtol 1e-9).
- ``solve_batch``: every lane against the JAX batch to 1e-9 with the same
  L, and against the port's own single solve to 1e-12 (1e-7 under Armijo,
  whose last-bit decisions the batched matmul can move).
- ``compat``: ``tests/test_compat.py`` ported case by case, at float64 (the
  default dtype set by a fixture, the counterpart of the reference's
  ``jax_enable_x64``), and each result against JAX's compat to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastoptsolver_tpu as J
from fastoptsolver_tpu import batch as JB, compat as JC, solvers as JS
from fastoptsolver_tpu.problems import (
    LeastSquares as JLS,
    generate_boston_like as j_boston,
    scenario_grid as j_grid,
)
import fastoptsolver_tpu_torch as T
from fastoptsolver_tpu_torch import api, compat
from fastoptsolver_tpu_torch import solvers as TS
from fastoptsolver_tpu_torch.batch import batch_lipschitz, solve_batch, stack_problems
from fastoptsolver_tpu_torch.bench import large_lasso
from fastoptsolver_tpu_torch.problems import (
    LeastSquares,
    X_TRUE,
    generate_boston_like,
    generate_scenario,
    generate_scenario_batch,
    scenario_grid,
)
from oracle_np import fista_np, ista_np, objective_np, shrink

torch.set_num_threads(1)


def _data(seed=0, m=200, n=12):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_true = np.zeros(n)
    x_true[:4] = 2 * rng.normal(size=4)
    return A, A @ x_true + 0.5 * rng.normal(size=m)


@pytest.fixture
def f64():
    """float64 as torch's default dtype for the test (compat follows it)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


# ---------------------------------------------------------------- solve

SOLVE_ATOL = {"fista": 1e-9, "fista_delta": 1e-9, "ista": 1e-9, "lbfgs": 1e-12, "cd": 1e-12,
              "admm": 1e-12, "owlqn": 1e-7}
REGS = {"lasso": (3.0, 0.0), "elasticnet": (2.0, 1.0), "ridge": (0.0, 1.0)}


@pytest.mark.parametrize("reg", list(REGS))
@pytest.mark.parametrize("method", list(SOLVE_ATOL))
def test_solve_matches_jax(method, reg):
    A, b = _data()
    a1, a2 = REGS[reg]
    rt = T.solve(A, b, reg, alpha1=a1, alpha2=a2, method=method, dtype=torch.float64,
                 device="cpu")
    rj = J.solve(A, b, reg, alpha1=a1, alpha2=a2, method=method, dtype=jnp.float64)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=SOLVE_ATOL[method])
    if method != "owlqn":
        assert int(rt.n_iters) == int(rj.n_iters)


@pytest.mark.parametrize("method", ["svrg", "saga"])
def test_solve_stochastic_reaches_the_optimum_as_jax_does(method):
    A, b = _data()
    kw = dict(epochs=300, batch=16, tol=0.0)
    rt = T.solve(A, b, "lasso", alpha1=3.0, method=method, dtype=torch.float64, device="cpu",
                 generator=torch.Generator().manual_seed(0), **kw)
    rj = J.solve(A, b, "lasso", alpha1=3.0, method=method, dtype=jnp.float64,
                 key=jax.random.PRNGKey(0), **kw)
    p = LeastSquares.create(A, b, "lasso", 3.0, dtype=torch.float64, device="cpu")
    _, f_star = TS.certified_optimum(p.to_gram(), TS.CDConfig(max_sweeps=50000, tol=1e-15))
    for x in (rt.x.numpy(), np.asarray(rj.x)):
        np.testing.assert_allclose(objective_np(x, A, b, 3.0, 0.0), float(f_star), rtol=1e-9)


@pytest.mark.parametrize("m_off,n,want", [(-1, 128, False), (0, 128, True),
                                         (0, 129, False), (-1, 5, False), (0, 5, True)])
def test_gram_rule(monkeypatch, m_off, n, want):
    """The Gram form iff n ≤ 128 and m ≥ 4n, for every method but lbfgs,
    svrg and saga; ``gram=`` overrides; the reference's own rule agrees."""
    m = 4 * n + m_off
    rng = np.random.default_rng(0)
    A, b = rng.normal(size=(m, n)), rng.normal(size=m)
    calls = []
    real = LeastSquares.to_gram
    monkeypatch.setattr(LeastSquares, "to_gram", lambda self: calls.append(1) or real(self))
    T.solve(A, b, "lasso", 1.0, method="fista", device="cpu", max_iter=1)
    assert bool(calls) == want == api.uses_gram("fista", m, n)
    for method in ("lbfgs", "svrg", "saga"):
        assert not api.uses_gram(method, m, n) and not api.uses_gram(method, m, n, gram=True)
    assert api.uses_gram("cd", m, n, gram=True) and not api.uses_gram("cd", m, n, gram=False)


def test_solve_rejects_unknown_options_methods_and_histories():
    A, b = _data()
    with pytest.raises(TypeError, match="bogus"):
        T.solve(A, b, "lasso", 1.0, method="fista", device="cpu", bogus=3)
    with pytest.raises(TypeError):
        T.solve(A, b, "lasso", 1.0, method="cd", device="cpu", max_iter=3)  # cd has max_sweeps
    with pytest.raises(ValueError, match="Unknown method"):
        T.solve(A, b, method="newton", device="cpu")
    for method in ("cd", "admm", "svrg", "saga"):
        with pytest.raises(ValueError, match="no history"):
            T.solve(A, b, "lasso", 1.0, method=method, history=True, device="cpu")


@pytest.mark.parametrize("method", ["fista", "fista_delta", "ista", "lbfgs", "owlqn"])
def test_solve_history_routes_to_the_history_variant(method):
    A, b = _data()
    r = T.solve(A, b, "lasso", 3.0, method=method, history=True, dtype=torch.float64,
                device="cpu", max_iter=30)
    rj = J.solve(A, b, "lasso", 3.0, method=method, history=True, dtype=jnp.float64,
                 max_iter=30)
    assert r.history.x.shape == (30, 12) and r.history.obj.shape == (30,)
    valid, valid_j = r.history.valid.numpy(), np.asarray(rj.history.valid)
    if method == "owlqn":  # its stop at the float64 floor: 12 rows here, 16 in JAX
        assert valid[:10].all() and valid_j[:10].all()
        valid = valid_j = valid & valid_j
    np.testing.assert_array_equal(valid, valid_j)
    # L from either start vector within ~1e-5 of λ_max moves an early
    # objective by ~3e-8 relative
    np.testing.assert_allclose(r.history.obj.numpy()[valid], np.asarray(rj.history.obj)[valid],
                               rtol=1e-7)


def test_fista_delta_defaults():
    A, b = _data()
    r = T.solve(A, b, "lasso", 3.0, method="fista_delta", dtype=torch.float64, device="cpu",
                max_iter=40)
    p = LeastSquares.create(A, b, "lasso", 3.0, dtype=torch.float64, device="cpu").to_gram()
    want = TS.fista(p, TS.fista_delta_config(3.0, max_iter=40), L=r.L)
    assert torch.equal(r.x, want.x)


def test_device_rule(monkeypatch):
    """NumPy input goes to the card unless a device is named: with no card,
    ``solve``, ``compat`` and the large-lasso bench raise, and
    ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.solve(A, b, "lasso", 1.0)
    with pytest.raises(RuntimeError):
        compat.fista(A, b, "lasso", 0.5, 0.0, max_iter=3)
    with pytest.raises(RuntimeError):
        large_lasso.run(m=64, n=8, iters=2)
    assert T.solve(A, b, "lasso", 1.0, device="cpu", max_iter=3).x.device.type == "cpu"
    xt = torch.as_tensor(A)
    assert T.solve(xt, b, "lasso", 1.0, max_iter=3).x.device.type == "cpu"  # a tensor keeps its device


# ---------------------------------------------------------------- batch


def _boston_pair(n_inst=4, reg="lasso", a1=0.5, a2=0.0, noises=None):
    tps, jps = [], []
    for s in range(n_inst):
        noise = 1.0 if noises is None else noises[s]
        A, b, _ = generate_boston_like(m=120, seed=s, noise_std=noise, rho1=0.5, rho2=0.7)
        A = (A - A.mean(0)) / A.std(0)
        tps.append(LeastSquares.create(A, b, reg, a1, a2, dtype=torch.float64, device="cpu"))
        jps.append(JLS.create(A, b, reg, a1, a2, dtype=jnp.float64))
    return tps, jps


def test_stack_problems_and_batch_lipschitz():
    tps, jps = _boston_pair(reg="elasticnet", a2=0.8)
    stacked = stack_problems(tps)
    assert stacked.A.shape == (4, 120, 5) and stacked.alpha2.shape == (4,)
    assert torch.equal(stacked.A[2], tps[2].A)
    with pytest.raises(ValueError, match="en_prox"):
        stack_problems([tps[0], LeastSquares.create(tps[1].A, tps[1].b, en_prox=True)])
    L = batch_lipschitz(stacked)
    Lj = JB.batch_lipschitz(JB.stack_problems(jps))
    # the loop stops once |ΔL| < 1e-6, which leaves L ≈ 200 within ~1e-5 of
    # λ_max from either start vector
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-7)
    lam = np.array([np.linalg.eigvalsh((p.A.T @ p.A).numpy())[-1] for p in tps]) + 0.8
    np.testing.assert_allclose(L.numpy(), lam, rtol=1e-7)
    gram = batch_lipschitz(stack_problems([p.to_gram() for p in tps]))
    np.testing.assert_allclose(gram.numpy(), lam, rtol=1e-7)


BATCH_CASES = {
    "fista_tol": ("fista", dict(max_iter=400, tol=1e-6), False),
    "fista_armijo_history": ("fista", dict(max_iter=8, backtracking=True), True),
    "ista_history": ("ista", dict(max_iter=40), True),
    "lbfgs": ("lbfgs", dict(), False),
    "lbfgs_history": ("lbfgs", dict(max_iter=40), True),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_solve_batch_matches_jax_and_the_single_solves(case):
    method, kw, hist = BATCH_CASES[case]
    tps, jps = _boston_pair(noises=[0.1, 1.0, 5.0, 10.0])
    cfg_t = {"fista": TS.FISTAConfig, "ista": TS.ISTAConfig, "lbfgs": TS.LBFGSConfig}[method](**kw)
    cfg_j = {"fista": JS.FISTAConfig, "ista": JS.ISTAConfig, "lbfgs": JS.LBFGSConfig}[method](**kw)
    Lj = JB.batch_lipschitz(JB.stack_problems(jps))
    L = torch.as_tensor(np.array(Lj))
    rt = solve_batch(stack_problems(tps), method, cfg_t, history=hist, L=L)
    rj = JB.solve_batch(JB.stack_problems(jps), method, cfg_j, history=hist, L=Lj)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-9)
    np.testing.assert_array_equal(rt.n_iters.numpy(), np.asarray(rj.n_iters))
    if hist:
        np.testing.assert_array_equal(rt.history.valid.numpy(), np.asarray(rj.history.valid))
        np.testing.assert_allclose(rt.history.obj.numpy(), np.asarray(rj.history.obj), rtol=1e-9)
    if case == "fista_tol":
        assert len(set(rt.n_iters.tolist())) > 1  # each lane stops at its own step
    single_atol = 1e-7 if kw.get("backtracking") else 1e-12
    for i, p in enumerate(tps):
        if method == "lbfgs":
            one = (TS.lbfgs_with_history if hist else TS.lbfgs)(p, cfg_t)
        else:
            one = getattr(TS, method + ("_with_history" if hist else ""))(p, cfg_t, L=L[i])
        assert int(one.n_iters) == int(rt.n_iters[i])
        np.testing.assert_allclose(rt.x[i].numpy(), one.x.numpy(), atol=single_atol)


def test_solve_batch_estimates_L_and_refuses_other_methods():
    tps, jps = _boston_pair()
    r = solve_batch(stack_problems(tps), "fista", TS.FISTAConfig(max_iter=50),
                    generator=torch.Generator().manual_seed(1))
    rj = JB.solve_batch(JB.stack_problems(jps), "fista", JS.FISTAConfig(max_iter=50))
    np.testing.assert_allclose(r.L.numpy(), np.asarray(rj.L), rtol=1e-7)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), atol=1e-9)
    with pytest.raises(ValueError, match="Unknown method"):
        solve_batch(stack_problems(tps), "cd")


# ---------------------------------------------------------------- generators


@pytest.mark.parametrize("kw", [dict(), dict(m=150, seed=3, noise_std=0.5, rho1=0.5, rho2=0.7)])
def test_generate_boston_like_is_the_references_bits(kw):
    for got, want in zip(generate_boston_like(**kw), j_boston(**kw)):
        assert np.array_equal(got, want)


def test_scenario_grid_is_the_references():
    assert scenario_grid() == j_grid() and len(scenario_grid()) == 80


def test_scenario_generators_shapes_and_moments():
    """The batch generator per lane: the block means and correlations, the
    noise level and ``x_true``, with per-lane ρ and noise; the single
    generator likewise."""
    grid = scenario_grid()
    B, m = len(grid), 4000
    noise = [g[1] for g in grid]
    rho1, rho2 = [g[2] for g in grid], [g[3] for g in grid]
    A, b, x_true = generate_scenario_batch(torch.Generator().manual_seed(0), B, m=m,
                                           noise_std=noise, rho1=rho1, rho2=rho2,
                                           dtype=torch.float64)
    assert A.shape == (B, m, 5) and b.shape == (B, m) and tuple(x_true.tolist()) == X_TRUE
    corr = lambda u, v: ((u - u.mean(1, keepdim=True)) * (v - v.mean(1, keepdim=True))).mean(1) / (
        u.std(1, unbiased=False) * v.std(1, unbiased=False))
    assert (corr(A[..., 0], A[..., 1]) - torch.tensor(rho1)).abs().max() < 0.05
    assert (corr(A[..., 2], A[..., 3]) - torch.tensor(rho2)).abs().max() < 0.05
    np.testing.assert_allclose(A.mean(1).mean(0).numpy(), [6.0, 0.2, 300.0, 60.0, 4.0],
                               rtol=0.02, atol=0.02)
    resid = b - A @ x_true
    assert ((resid.std(1) - torch.tensor(noise)) / torch.tensor(noise)).abs().max() < 0.06
    A1, b1, _ = generate_scenario(torch.Generator().manual_seed(0), m=m, noise_std=2.0,
                                  rho1=0.8, rho2=0.9, dtype=torch.float64)
    assert A1.shape == (m, 5) and abs(float(corr(A1[None, :, 0], A1[None, :, 1])) - 0.8) < 0.05


# ---------------------------------------------------------------- compat


def _cdata(seed=0):
    A, b, _ = compat.generate_correlated_boston_like_data(m=150, seed=seed, noise_std=1.0,
                                                          rho1=0.5, rho2=0.7)
    return (A - A.mean(0)) / A.std(0), b


def test_compat_prox_functions(f64):
    v = np.array([-2.0, -0.1, 0.0, 0.4, 3.0])
    np.testing.assert_allclose(compat.prox_l1(v, 0.5, device="cpu"), shrink(v, 0.5))
    np.testing.assert_allclose(compat.prox_elastic_net(v, 0.5, 0.4, 2.0, device="cpu"),
                               shrink(v, 0.2) / 2.0)
    np.testing.assert_allclose(compat.prox_l1(v, 0.5, device="cpu"), JC.prox_l1(v, 0.5))


def test_compat_objective_and_validation(f64):
    A, b = _cdata()
    x = np.ones(5)
    got = compat.compute_objective(x, A, b, "elasticnet", 0.3, 0.7, device="cpu")
    np.testing.assert_allclose(got, objective_np(x, A, b, 0.3, 0.7), rtol=1e-12)
    np.testing.assert_allclose(got, JC.compute_objective(x, A, b, "elasticnet", 0.3, 0.7),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        compat.compute_objective(x, A, b, "bogus", 0.1, 0.1, device="cpu")


def test_compat_estimate_lipschitz_deterministic(f64):
    A, b = _cdata()
    L1 = compat.estimate_lipschitz(A, device="cpu")
    assert L1 == compat.estimate_lipschitz(A, device="cpu")
    np.testing.assert_allclose(L1, float(np.linalg.eigvalsh(A.T @ A)[-1]), rtol=1e-4)
    np.testing.assert_allclose(L1, JC.estimate_lipschitz(A), rtol=1e-4)


def test_compat_fista_signature_and_history(f64):
    A, b = _cdata()
    x, hist = compat.fista(A, b, "lasso", 0.5, 0.0, max_iter=40, return_history=True,
                           device="cpu")
    assert set(hist) == {"x", "obj"}
    assert len(hist["x"]) == 41 and len(hist["obj"]) == 40  # x₀ included (reference :160)
    np.testing.assert_allclose(hist["x"][0], np.zeros(5))
    x_ref, _ = fista_np(A, b, 0.5, 0.0, compat.estimate_lipschitz(A, device="cpu"), max_iter=40)
    np.testing.assert_allclose(x, x_ref, rtol=1e-6, atol=1e-8)
    xj, hj = JC.fista(A, b, "lasso", 0.5, 0.0, max_iter=40, return_history=True)
    np.testing.assert_allclose(x, xj, atol=1e-9)
    np.testing.assert_allclose(hist["obj"], hj["obj"], rtol=1e-9)
    m = compat.get_metrics()
    assert m["grad_num_calls"] == 40 and m["grad_time_total"] > 0
    compat.reset_metrics()
    assert compat.get_metrics()["grad_num_calls"] == 0


def test_compat_fista_delta_history_excludes_x0(f64):
    A, b = _cdata()
    x, hist = compat.fista_delta(A, b, "lasso", 0.5, 0.0, delta=3.0, max_iter=25,
                                 return_history=True, device="cpu")
    assert len(hist["x"]) == 25 and len(hist["obj"]) == 25  # no x₀ (reference :279)
    xj, hj = JC.fista_delta(A, b, "lasso", 0.5, 0.0, delta=3.0, max_iter=25,
                            return_history=True)
    np.testing.assert_allclose(np.array(hist["x"]), np.array(hj["x"]), atol=1e-9)
    with pytest.raises(AssertionError):
        compat.fista_delta(A, b, "lasso", 0.5, 0.0, delta=2.0, device="cpu")
    with pytest.raises(ValueError):
        compat.fista(A, b, "bogus", 0.5, 0.0, device="cpu")


def test_compat_fista_armijo_counts(f64):
    A, b = _cdata()
    compat.fista(A, b, "elasticnet", 0.5, 0.8, backtracking=True, t_init_factor=2.0,
                 max_iter=8, device="cpu")
    m = compat.get_metrics()
    JC.fista(A, b, "elasticnet", 0.5, 0.8, backtracking=True, t_init_factor=2.0, max_iter=8)
    mj = JC.get_metrics()
    for k in ("grad_num_calls", "ls_num_calls", "ls_iters_total"):
        assert m[k] == mj[k]
    assert m["ls_iters_total"] > 0


def test_compat_ista_generic_closures(f64):
    """The closures are written on torch tensors, which ``ista`` hands them."""
    A, b = _cdata()
    L = compat.estimate_lipschitz(A, device="cpu")
    a1 = 0.5
    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def g(x):
        r = At @ x - bt
        return 0.5 * r @ r

    def grad_g(x):
        return At.T @ (At @ x - bt)

    def prox_h(v, t):
        return torch.sign(v) * torch.clamp_min(torch.abs(v) - t * a1, 0.0)

    x, log = compat.ista(np.zeros(5), g, grad_g, prox_h, L, max_iter=30, return_history=True,
                         device="cpu")
    assert set(log) == {"x", "t", "delta"}
    assert len(log["x"]) == 31 and len(log["t"]) == 31 and len(log["delta"]) == 30
    x_ref, _ = ista_np(A, b, a1, 0.0, L, max_iter=30)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)
    xb = compat.ista(np.zeros(5), g, grad_g, prox_h, L, backtracking=True, t_init_factor=4.0,
                     max_iter=20, device="cpu")
    xb_ref, _ = ista_np(A, b, a1, 0.0, L, backtracking=True, t_init_factor=4.0, max_iter=20)
    np.testing.assert_allclose(xb, xb_ref, rtol=1e-8, atol=1e-10)
    assert compat.get_metrics()["ls_num_calls"] == 20


def test_compat_lbfgs_solver_class(f64):
    A, b = _cdata()
    solver = compat.LBFGSSolver("ridge", 0.0, 1.0, tol=1e-10, device="cpu").fit(A, b)
    x_star = np.linalg.solve(A.T @ A + np.eye(5), A.T @ b)
    np.testing.assert_allclose(solver.x_, x_star, rtol=1e-4)
    assert len(solver.history_) > 0
    np.testing.assert_allclose(solver.final_obj_, objective_np(solver.x_, A, b, 0.0, 1.0),
                               rtol=1e-10)
    ref = JC.LBFGSSolver("ridge", 0.0, 1.0, tol=1e-10).fit(A, b)
    np.testing.assert_allclose(solver.final_obj_, ref.final_obj_, rtol=1e-12)
    assert compat.LBFGSSolver("elasticnet", 1e-12, 1.0).reg_type == "ridge"
    assert compat.LBFGSSolver("elasticnet", 1.0, 1e-12).reg_type == "lasso"
    with pytest.raises(ValueError):
        compat.LBFGSSolver("bogus", 0.1, 0.1)
    # lasso quirk: the smooth part minimized, the full objective recorded
    solver = compat.LBFGSSolver("lasso", 5.0, 0.0, tol=1e-10, device="cpu").fit(A, b)
    np.testing.assert_allclose(solver.x_, np.linalg.lstsq(A, b, rcond=None)[0], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(solver.history_[-1], objective_np(solver.x_, A, b, 5.0, 0.0),
                               rtol=1e-8)


def test_compat_lbfgs_against_scipy(f64):
    """The upstream's own call: ``scipy.optimize.fmin_l_bfgs_b`` on the same
    ridge objective; the port's final objective no worse by 1e-10."""
    from scipy.optimize import fmin_l_bfgs_b

    A, b = _cdata()

    def fg(x):
        r = A @ x - b
        return 0.5 * r @ r + 0.5 * x @ x, A.T @ r + x

    _, f_sp, _ = fmin_l_bfgs_b(fg, np.zeros(5))
    solver = compat.LBFGSSolver("ridge", 0.0, 1.0, device="cpu").fit(A, b)
    assert solver.final_obj_ <= f_sp * (1 + 1e-10)


def test_compat_data_generator_alias():
    A, b, xt = compat.generate_correlated_boston_like_data(m=200, seed=3)
    assert A.shape == (200, 5)
    np.testing.assert_allclose(xt, [5.0, 0.0, -0.02, -0.05, 1.5])


def test_compat_follows_the_default_dtype():
    """float32 unless the caller sets float64, as the reference follows
    ``jax_enable_x64``."""
    A, b = _cdata()
    x32 = compat.fista(A, b, "lasso", 0.5, 0.0, max_iter=5, device="cpu")
    assert x32.dtype == np.float32
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert compat.fista(A, b, "lasso", 0.5, 0.0, max_iter=5, device="cpu").dtype == np.float64
    finally:
        torch.set_default_dtype(old)


# ---------------------------------------------------------------- large lasso


def test_large_lasso_record_on_the_cpu():
    """At a tiny size on the CPU: the record's keys, A read twice an
    iteration, no device numbers, and the problem and solution it returns."""
    m, n, iters = 512, 32, 20
    rec, problem, x_run = large_lasso.run(m, n, iters, device="cpu")
    for key in ("m", "n", "iters", "seconds", "lipschitz_seconds", "L", "iters_per_s",
                "ms_per_iter", "a_bytes", "matvecs", "bytes_read", "achieved_gbps",
                "achieved_tflops", "bound_ms_per_iter", "pct_of_bound", "stream_ceiling_gbps",
                "pct_of_ceiling", "objective", "nnz_frac", "device"):
        assert key in rec
    assert rec["a_bytes"] == m * n * 4 and rec["matvecs"] == 2 * iters
    assert rec["bytes_read"] == 2 * iters * m * n * 4
    np.testing.assert_allclose(rec["bound_ms_per_iter"], 2 * m * n * 4 / 3.35e12 * 1e3)
    assert rec["device"] == "cpu" and rec["stream_ceiling_gbps"] is None
    assert 0.0 < rec["nnz_frac"] < 1.0 and np.isfinite(rec["objective"])
    # the same data and L as the record's, solved again
    A, b, a1 = large_lasso.build(m, n, torch.Generator().manual_seed(0))
    p = LeastSquares(A=A, b=b, alpha1=a1, alpha2=A.new_zeros(()))
    assert torch.equal(problem.A, A) and torch.equal(problem.b, b)
    assert float(problem.objective(x_run)) == rec["objective"]
    x = TS.fista(p, TS.FISTAConfig(max_iter=iters), L=rec["L"]).x
    np.testing.assert_allclose(float(p.objective(x)), rec["objective"], rtol=1e-6)
