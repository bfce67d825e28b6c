"""The port's problems (``fastoptsolver_tpu_torch.problems``) against the JAX
package's on the same seeded numpy inputs, float32 on both sides:
``fold_alphas`` over every ``reg_type`` and the ε reclassification (exact:
plain Python), and ``LeastSquares`` (both prox forms), ``GramLeastSquares``,
``LogisticRegression`` and ``CustomProblem`` values, gradients, prox and
``to_gram`` at rtol 1e-5 (the prox, elementwise, at 1e-6). Also the device
rule of ``create``: a tensor keeps its device, numpy goes to ``device`` or
the card, and raises without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu import problems as jpr
from fastoptsolver_tpu_torch import problems as tpr

torch.set_num_threads(1)

RTOL = 1e-5


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(port, ref, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("reg", ["lasso", "ridge", "elasticnet"])
@pytest.mark.parametrize("a1,a2,eps", [(0.3, 0.5, 0.0), (1e-9, 0.5, 1e-6),
                                        (0.3, 1e-9, 1e-6), (0.3, 0.5, 1e-6)])
def test_fold_alphas_matches_jax(reg, a1, a2, eps):
    assert tpr.fold_alphas(reg, a1, a2, eps) == jpr.fold_alphas(reg, a1, a2, eps)


def test_fold_alphas_rejects_unknown_and_reg_types():
    assert tpr.REG_TYPES == jpr.REG_TYPES
    with pytest.raises(ValueError, match="reg_type"):
        tpr.fold_alphas("bogus", 0.1, 0.1)


def _evaluate(p, x, v):
    """Every protocol method of ``p`` at ``x`` (prox at ``v``, τ = 0.3)."""
    val, grad = p.smooth_value_and_grad(x)
    return dict(smooth_value=p.smooth_value(x), smooth_grad=p.smooth_grad(x),
                vg_value=val, vg_grad=grad, prox=p.prox(v, 0.3),
                nonsmooth=p.nonsmooth_value(x), objective=p.objective(x), x0=p.x0())


def _compare(jp, tp, rng, n):
    x, v = _f32(rng, n), _f32(rng, n)
    ref = _evaluate(jp, jnp.asarray(x), jnp.asarray(v))
    out = _evaluate(tp, torch.from_numpy(x), torch.from_numpy(v))
    for k in ref:
        _close(out[k], ref[k], rtol=1e-6 if k == "prox" else RTOL)
    assert tp.dim == jp.dim == n


@pytest.mark.parametrize("reg,en_prox", [("lasso", False), ("ridge", False),
                                         ("elasticnet", False), ("elasticnet", True)])
def test_least_squares_matches_jax(rng, reg, en_prox):
    A, b = _f32(rng, 25, 6), _f32(rng, 25)
    kw = dict(alpha1=0.4, alpha2=0.7, en_prox=en_prox)
    jp = jpr.LeastSquares.create(A, b, reg, **kw)
    tp = tpr.LeastSquares.create(A, b, reg, device="cpu", **kw)
    _compare(jp, tp, rng, 6)
    assert tp.ridge_in_smooth == jp.ridge_in_smooth
    _close(tp.residual(torch.ones(6)), jp.residual(jnp.ones(6)))
    if en_prox:
        with pytest.raises(NotImplementedError):
            tp.to_gram()
        return
    jg, tg = jp.to_gram(), tp.to_gram()
    for f in ("Q", "c", "btb", "alpha1", "alpha2"):
        _close(getattr(tg, f), getattr(jg, f))
    _compare(jg, tg, rng, 6)


def test_gram_least_squares_create_matches_jax(rng):
    A, b = _f32(rng, 30, 5), _f32(rng, 30)
    jg = jpr.GramLeastSquares.create(A, b, "elasticnet", alpha1=0.2, alpha2=0.3)
    tg = tpr.GramLeastSquares.create(A, b, "elasticnet", alpha1=0.2, alpha2=0.3, device="cpu")
    _compare(jg, tg, rng, 5)


def test_logistic_regression_matches_jax(rng):
    A = _f32(rng, 40, 6)
    y = np.where(rng.random(40) < 0.5, -1.0, 1.0).astype(np.float32)
    jp = jpr.LogisticRegression.create(A, y, alpha1=0.1, alpha2=0.5)
    tp = tpr.LogisticRegression.create(A, y, alpha1=0.1, alpha2=0.5, device="cpu")
    _compare(jp, tp, rng, 6)
    # margins past softplus' linear cut-off: still log(1 + exp(·)) exactly
    big = 30.0 * np.ones(6, np.float32)
    _close(tp.smooth_value(torch.from_numpy(big)), jp.smooth_value(jnp.asarray(big)))


def test_custom_problem_matches_jax(rng):
    """Closures with and without a gradient (``torch.func.grad`` against
    ``jax.grad``), a prox and a nonsmooth value, and the defaults."""
    A, b = _f32(rng, 20, 4), _f32(rng, 20)
    jA, jb, tA, tb = jnp.asarray(A), jnp.asarray(b), torch.from_numpy(A), torch.from_numpy(b)
    cases = [
        (jpr.CustomProblem(params=dict(A=jA, b=jb), n_dim=4,
                           smooth_value_fn=lambda x, A, b: 0.5 * jnp.sum((A @ x - b) ** 2),
                           prox_fn=lambda v, tau, A, b: jnp.maximum(v, 0.0),
                           nonsmooth_value_fn=lambda x, A, b: jnp.sum(jnp.abs(x))),
         tpr.CustomProblem(params=dict(A=tA, b=tb), n_dim=4,
                           smooth_value_fn=lambda x, A, b: 0.5 * torch.sum((A @ x - b) ** 2),
                           prox_fn=lambda v, tau, A, b: torch.clamp_min(v, 0.0),
                           nonsmooth_value_fn=lambda x, A, b: torch.sum(torch.abs(x)))),
        (jpr.CustomProblem(params=dict(A=jA), n_dim=4,
                           smooth_value_fn=lambda x, A: jnp.sum(jnp.cosh(A @ x)),
                           smooth_grad_fn=lambda x, A: A.T @ jnp.sinh(A @ x)),
         tpr.CustomProblem(params=dict(A=tA), n_dim=4,
                           smooth_value_fn=lambda x, A: torch.sum(torch.cosh(A @ x)),
                           smooth_grad_fn=lambda x, A: A.T @ torch.sinh(A @ x))),
    ]
    for jp, tp in cases:
        x, v = 0.1 * _f32(rng, 4), _f32(rng, 4)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        _close(tp.smooth_value(tx), jp.smooth_value(jx))
        _close(tp.smooth_grad(tx), jp.smooth_grad(jx))
        _close(tp.prox(torch.from_numpy(v), 0.3), jp.prox(jnp.asarray(v), 0.3))
        _close(tp.nonsmooth_value(tx), jp.nonsmooth_value(jx))
        _close(tp.objective(tx), jp.objective(jx))
        assert tp.dim == jp.dim


def test_create_device_rule(rng, monkeypatch):
    A, b = _f32(rng, 10, 3), _f32(rng, 10)
    p = tpr.LeastSquares.create(torch.from_numpy(A), b, "lasso", alpha1=0.1)
    assert p.A.device.type == p.b.device.type == p.alpha1.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tpr.LeastSquares.create(A, b, "lasso", alpha1=0.1),
                 lambda: tpr.GramLeastSquares.create(A, b, "lasso", alpha1=0.1),
                 lambda: tpr.LogisticRegression.create(A, np.sign(b), alpha1=0.1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
