"""The port's stochastic solvers (``fastoptsolver_tpu_torch.solvers.
{svrg,saga}``) on the CPU, float64.

Their row permutations come from a ``torch.Generator`` where the JAX
package's come from ``jax.random`` keys, so the two paths cannot match; both
are held against the optimum instead, with the tolerances the JAX package's
own tests use (``tests/test_svrg.py``, ``tests/test_saga.py``): the objective
within 1e-9 of CD's certified f* and x within 1e-5 of its x*. One generator
seed gives the same bits twice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu import solvers as JS
from fastoptsolver_tpu.problems import LeastSquares as JLS
from fastoptsolver_tpu_torch import solve
from fastoptsolver_tpu_torch import solvers as TS
from fastoptsolver_tpu_torch.ops import estimate_lipschitz
from fastoptsolver_tpu_torch.problems import LeastSquares

torch.set_num_threads(1)

F_ATOL = 1e-9  # f − f* (the JAX tests' bar)
X_ATOL = 1e-5  # ‖x − x*‖∞


def _data(seed=0, m=200, n=12):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x_true = np.zeros(n)
    x_true[: n // 3] = rng.normal(size=n // 3) * 2
    return A, A @ x_true + 0.1 * rng.normal(size=m)


def _problem(reg, a1, a2, seed=0):
    A, b = _data(seed)
    p = LeastSquares.create(A, b, reg, a1, a2, dtype=torch.float64, device="cpu")
    x_star, f_star = TS.certified_optimum(p.to_gram(), TS.CDConfig(max_sweeps=50000, tol=1e-15))
    return p, A, b, x_star, float(f_star)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


CASES = {"lasso": ("lasso", 3.0, 0.0), "enet": ("elasticnet", 2.0, 1.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_svrg_reaches_the_optimum_as_jax_does(case):
    reg, a1, a2 = CASES[case]
    p, A, b, x_star, f_star = _problem(reg, a1, a2)
    L = estimate_lipschitz(p.A) + p.alpha2
    res = TS.prox_svrg(p, L, TS.SVRGConfig(epochs=150, batch=16, tol=0.0), generator=_gen(0))
    assert float(p.objective(res.x)) - f_star < F_ATOL
    np.testing.assert_allclose(res.x.numpy(), x_star.numpy(), atol=X_ATOL)
    pj = JLS.create(A, b, reg, a1, a2, dtype=jnp.float64)
    rj = JS.prox_svrg(pj, jnp.asarray(float(L)), JS.SVRGConfig(epochs=150, batch=16, tol=0.0),
                      key=jax.random.PRNGKey(0))
    assert float(pj.objective(rj.x)) - f_star < F_ATOL
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj.x), atol=2 * X_ATOL)
    # the counters follow the reference's rule: a full pass + 2 evals a step
    steps = 200 // 16
    assert int(res.metrics.n_grad_evals) == int(res.n_iters) * (1 + 2 * steps)
    np.testing.assert_allclose(float(res.final_tau), 0.1 / float(L), rtol=1e-15)


@pytest.mark.parametrize("case", list(CASES))
def test_saga_reaches_the_optimum_as_jax_does(case):
    reg, a1, a2 = CASES[case]
    p, A, b, x_star, f_star = _problem(reg, a1, a2)
    res = TS.prox_saga(p, TS.SAGAConfig(epochs=200, batch=16, tol=0.0), generator=_gen(0))
    assert float(p.objective(res.x)) - f_star < F_ATOL
    np.testing.assert_allclose(res.x.numpy(), x_star.numpy(), atol=X_ATOL)
    pj = JLS.create(A, b, reg, a1, a2, dtype=jnp.float64)
    rj = JS.prox_saga(pj, JS.SAGAConfig(epochs=200, batch=16, tol=0.0), key=jax.random.PRNGKey(0))
    assert float(pj.objective(rj.x)) - f_star < F_ATOL
    # the step from the largest row norm: the same L_max and η as JAX's
    np.testing.assert_allclose(float(res.L), float(rj.L), rtol=1e-14)
    np.testing.assert_allclose(float(res.final_tau), float(rj.final_tau), rtol=1e-14)


@pytest.mark.parametrize("method", ["svrg", "saga"])
def test_one_generator_seed_gives_the_same_bits(method):
    p, *_ = _problem("lasso", 3.0, 0.0)
    L = estimate_lipschitz(p.A)

    def run(seed):
        if method == "svrg":
            return TS.prox_svrg(p, L, TS.SVRGConfig(epochs=5, batch=16), generator=_gen(seed)).x
        return TS.prox_saga(p, TS.SAGAConfig(epochs=5, batch=16), generator=_gen(seed)).x

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    assert torch.equal(run(0), TS.prox_svrg(p, L, TS.SVRGConfig(epochs=5, batch=16)).x
                       if method == "svrg" else
                       TS.prox_saga(p, TS.SAGAConfig(epochs=5, batch=16)).x)


@pytest.mark.parametrize("method", ["svrg", "saga"])
def test_flat_objective_stops_early(method):
    """A flat objective for ``patience`` epochs stops the run short of
    ``epochs``, at the optimum."""
    p, A, b, x_star, f_star = _problem("lasso", 3.0, 0.0)
    if method == "svrg":
        res = TS.prox_svrg(p, estimate_lipschitz(p.A),
                           TS.SVRGConfig(epochs=300, batch=16, tol=1e-14), generator=_gen(0))
        limit = 300
    else:
        res = TS.prox_saga(p, TS.SAGAConfig(epochs=400, batch=16, tol=1e-14), generator=_gen(0))
        limit = 400
    assert int(res.n_iters) < limit
    assert float(p.objective(res.x)) - f_star < 1e-8


def test_svrg_gradient_map_tolerance_stops():
    p, A, b, x_star, f_star = _problem("lasso", 3.0, 0.0)
    L = estimate_lipschitz(p.A)
    res = TS.prox_svrg(p, L, TS.SVRGConfig(epochs=150, batch=16, tol=0.0, gradmap_tol=1e-3),
                       generator=_gen(0))
    eta = 0.1 / float(L)
    x = res.x
    gm = x - p.prox(x - eta * p.smooth_grad(x), eta)
    assert int(res.n_iters) < 150 and float(torch.linalg.norm(gm)) / eta <= 1e-3


@pytest.mark.parametrize("method", ["svrg", "saga"])
def test_through_solve(method):
    """``solve(method=...)`` runs the solver on raw (A, b), never the Gram."""
    A, b = _data()
    res = solve(A, b, "lasso", alpha1=3.0, method=method, dtype=torch.float64, device="cpu",
                epochs=200, batch=16, tol=0.0, generator=_gen(3))
    p, _, _, x_star, f_star = _problem("lasso", 3.0, 0.0)
    np.testing.assert_allclose(float(p.objective(res.x)), f_star, rtol=1e-9)
