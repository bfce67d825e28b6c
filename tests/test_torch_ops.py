"""The port's ops (``fastoptsolver_tpu_torch.ops``) against the JAX package's
on the same seeded numpy inputs, float32 on both sides: the elementwise
functions (every prox, the isotonic projection) at rtol 1e-6, the reductions
(objective, both gap forms, ``relative_gap``, ``slope_norm``) at rtol 1e-5,
``_power_iteration`` from the same start vector at rtol 1e-5. The public
Lipschitz estimates start from other vectors in the two packages (a torch
generator against ``jax.random``), so they are held within 1e-3 of JAX's and
at most ``numpy.linalg.eigvalsh``'s λ_max·(1 + 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu import ops as jops
from fastoptsolver_tpu.ops.gap import _gap_from_parts as j_gap_from_parts
from fastoptsolver_tpu.ops.lipschitz import _power_iteration as j_power_iteration
from fastoptsolver_tpu.problems import LeastSquares as JLS
from fastoptsolver_tpu_torch import ops
from fastoptsolver_tpu_torch.ops.gap import _gap_from_parts
from fastoptsolver_tpu_torch.ops.lipschitz import _power_iteration
from fastoptsolver_tpu_torch.problems import GramLeastSquares, LeastSquares

torch.set_num_threads(1)

ELEMENTWISE_RTOL = 1e-6
REDUCTION_RTOL = 1e-5


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _prox_cases(rng):
    v = _f32(rng, 7, 9)
    tau = np.abs(_f32(rng, 9)) + 0.1
    w = _f32(rng, 11)
    lam = np.sort(np.abs(_f32(rng, 11)))[::-1].copy()
    return [
        ("soft_threshold", (v, tau), {}),
        ("prox_l1", (v, 0.3), {}),
        ("prox_elastic_net", (v, tau, 0.7, 0.4), {}),
        ("prox_group_lasso", (v, 0.8), {}),
        ("prox_group_lasso", (v, 0.8), {"axis": 0}),
        ("prox_nonneg", (v,), {}),
        ("prox_box", (v, 0.0, -0.5, 0.25), {}),
        ("prox_zero", (v,), {}),
        ("isotonic_regression", (w,), {}),
        ("isotonic_regression", (w,), {"increasing": False}),
        ("prox_slope", (w, lam), {}),
        ("prox_slope", (w, 0.4), {}),
    ]


@pytest.mark.parametrize("case", range(12))
def test_prox_matches_jax(case):
    name, args, kw = _prox_cases(np.random.default_rng(case))[case]
    ref = getattr(jops, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args), **kw)
    out = getattr(ops, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in args), **kw)
    assert out.dtype == torch.float32
    _close(out, ref, ELEMENTWISE_RTOL, atol=1e-7)


def test_slope_norm_and_slope_prox_recover_l1(rng):
    x = _f32(rng, 13)
    lam = np.sort(np.abs(_f32(rng, 13)))[::-1].copy()
    _close(ops.slope_norm(torch.from_numpy(x), torch.from_numpy(lam)),
           jops.slope_norm(jnp.asarray(x), jnp.asarray(lam)), REDUCTION_RTOL)
    # a constant ladder is the L1 prox
    _close(ops.prox_slope(torch.from_numpy(x), 0.3),
           ops.soft_threshold(torch.from_numpy(x), 0.3), ELEMENTWISE_RTOL, atol=1e-7)


@pytest.mark.parametrize("reg,a1,a2", [("lasso", 0.3, 0.0), ("ridge", 0.0, 0.5),
                                       ("elasticnet", 0.3, 0.5)])
def test_compute_objective_matches_jax(rng, reg, a1, a2):
    A, b, x = _f32(rng, 20, 6), _f32(rng, 20), _f32(rng, 6)
    ref = jops.compute_objective(jnp.asarray(x), jnp.asarray(A), jnp.asarray(b), reg, a1, a2)
    out = ops.compute_objective(torch.from_numpy(x), torch.from_numpy(A),
                                torch.from_numpy(b), reg, a1, a2)
    _close(out, ref, REDUCTION_RTOL)
    with pytest.raises(ValueError, match="reg_type"):
        ops.compute_objective(torch.from_numpy(x), torch.from_numpy(A),
                              torch.from_numpy(b), "bogus", a1, a2)


@pytest.mark.parametrize("reg,a1,a2", [("lasso", 2.0, 0.0), ("elasticnet", 2.0, 0.7),
                                       ("ridge", 0.0, 0.7), ("lasso", 0.0, 0.0)])
def test_duality_gap_both_forms_match_jax(rng, reg, a1, a2):
    """The L1 gap, the strong-convexity bound (α₁ = 0) and the bare
    stationarity measure, dense and Gram form, and ``relative_gap``."""
    A, b, x = _f32(rng, 30, 8), _f32(rng, 30), 0.3 * _f32(rng, 8)
    jp = JLS.create(A, b, reg, alpha1=a1, alpha2=a2)
    tp = LeastSquares.create(A, b, reg, alpha1=a1, alpha2=a2, device="cpu")
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for j, t in ((jp, tp), (jp.to_gram(), tp.to_gram())):
        _close(ops.lasso_duality_gap(t, tx), jops.lasso_duality_gap(j, jx), REDUCTION_RTOL)
        _close(ops.relative_gap(t, tx), jops.relative_gap(j, jx), REDUCTION_RTOL)
    # a certificate is never negative
    assert float(ops.lasso_duality_gap(tp, tx)) >= 0.0


def test_gap_from_parts_per_lane(rng):
    """The assembly on per-lane vectors, both branches of the scaling."""
    parts = [np.abs(_f32(rng, 16)) * s for s in (10.0, 1.0, 1.0, 3.0, 5.0, 2.0)]
    parts[1] = -parts[1]
    a1 = np.where(np.arange(16) % 3 == 0, 0.0, 1.5).astype(np.float32)
    a2 = np.where(np.arange(16) % 2 == 0, 0.0, 0.4).astype(np.float32)
    ref = j_gap_from_parts(*(jnp.asarray(p) for p in parts), jnp.asarray(a1), jnp.asarray(a2))
    out = _gap_from_parts(*(torch.from_numpy(p) for p in parts), torch.from_numpy(a1),
                          torch.from_numpy(a2))
    _close(out, ref, REDUCTION_RTOL)


def test_power_iteration_same_v0_matches_jax(rng):
    A = _f32(rng, 40, 10)
    Q = A.T @ A
    v0 = _f32(rng, 10)
    for n_iter, tol in ((100, 1e-6), (7, 1e-6), (100, 1e-1)):
        ref = j_power_iteration(lambda v: jnp.asarray(Q) @ v, jnp.asarray(v0), n_iter, tol)
        out = _power_iteration(lambda v: torch.from_numpy(Q) @ v, torch.from_numpy(v0),
                               n_iter, tol)
        _close(out, ref, 1e-5)


def test_stacked_power_iteration_stops_each_problem_like_vmap(rng):
    """A stack of Grams with the one shared v0 freezes each problem at its
    own stop, as ``jax.vmap`` of the reference's ``while_loop`` does: the
    slow problem keeps going, the fast one keeps the λ of its own last step."""
    n = 8
    fast = np.diag(np.r_[10.0, 8.0, np.ones(n - 2)]).astype(np.float32)
    slow = np.diag(np.r_[10.0, 9.9, np.ones(n - 2)]).astype(np.float32)
    Qs = np.stack([fast, slow, 4 * slow])
    v0 = np.ones(n, np.float32)
    tol = 1e-2
    ref = jax.vmap(lambda Q: j_power_iteration(lambda v: Q @ v, jnp.asarray(v0), 100, tol))(
        jnp.asarray(Qs))
    TQ = torch.from_numpy(Qs)
    out = _power_iteration(lambda v: (TQ @ v[..., None])[..., 0],
                           torch.from_numpy(v0).expand(3, n), 100, tol)
    _close(out, ref, 1e-5)
    # each problem's L is what it gets run alone
    for i in range(3):
        alone = _power_iteration(lambda v: TQ[i] @ v, torch.from_numpy(v0), 100, tol)
        _close(out[i], alone, 1e-6)
    # the fast problem froze early: run to the slow one's stop (all 100
    # steps) it would have moved on
    run_on = _power_iteration(lambda v: TQ[0] @ v, torch.from_numpy(v0), 100, 0.0)
    assert float(out[0]) < float(run_on) - 1e-4


@pytest.mark.parametrize("tol", [1e-2, 1e-6])
def test_power_iteration_reads_the_stop_every_few_steps(rng, tol, monkeypatch):
    """The stop test is read on the host once every ``_STOP_EVERY`` steps:
    the same bits as a read every step, and at most ``_STOP_EVERY - 1``
    extra matvecs past the last problem's stop."""
    from fastoptsolver_tpu_torch.ops import lipschitz

    n = 8
    TQ = torch.from_numpy(np.stack([np.diag(np.r_[10.0, 8.0, np.ones(n - 2)]),
                                    _f32(rng, 12, n).T @ _f32(rng, 12, n)]).astype(np.float32))
    v0 = torch.from_numpy(_f32(rng, n)).expand(2, n)

    def run(every):
        calls = []
        monkeypatch.setattr(lipschitz, "_STOP_EVERY", every)
        L = _power_iteration(lambda v: (calls.append(1), (TQ @ v[..., None])[..., 0])[1],
                             v0, 100, tol)
        return L, len(calls)
    (L1, steps1), (L10, steps10) = run(1), run(10)
    assert torch.equal(L1, L10)
    assert steps1 <= steps10 <= min(steps1 + 9, 100)


def test_lipschitz_estimates_match_jax_and_eigvalsh(rng):
    A = _f32(rng, 50, 9)
    Q = A.T @ A
    lam = np.linalg.eigvalsh(Q.astype(np.float64)).max()
    Qs = np.stack([Q, 2.0 * Q + np.eye(9, dtype=np.float32)])
    lam_s = np.array([np.linalg.eigvalsh(q.astype(np.float64)).max() for q in Qs])
    tA, tQ = torch.from_numpy(A), torch.from_numpy(Q)
    cases = [
        (ops.estimate_lipschitz(tA), jops.estimate_lipschitz(jnp.asarray(A)), lam),
        (ops.estimate_lipschitz_gram(tQ), jops.estimate_lipschitz_gram(jnp.asarray(Q)), lam),
        (ops.estimate_lipschitz_gram(torch.from_numpy(Qs)),
         jax.vmap(jops.estimate_lipschitz_gram)(jnp.asarray(Qs)), lam_s),
    ]
    for out, ref, top in cases:
        _close(out, ref, 1e-3)
        assert np.all(np.asarray(out) <= top * (1 + 1e-5))
    # an explicit generator is reproducible
    g = lambda: torch.Generator().manual_seed(7)
    assert torch.equal(ops.estimate_lipschitz(tA, g()), ops.estimate_lipschitz(tA, g()))


@pytest.mark.parametrize("form", ["dense", "gram", "en_prox", "normal_matvec"])
def test_lipschitz_for_matches_jax(rng, form):
    A, b = _f32(rng, 40, 7), _f32(rng, 40)
    kw = dict(reg_type="elasticnet", alpha1=0.2, alpha2=1.5)
    jp = JLS.create(A, b, en_prox=form == "en_prox", **kw)
    tp = LeastSquares.create(A, b, en_prox=form == "en_prox", device="cpu", **kw)
    if form == "gram":
        jp, tp = jp.to_gram(), tp.to_gram()
    if form == "normal_matvec":
        class Op:  # a problem that brings its own AᵀA operator, duck-typed
            def __init__(self, p, mv):
                self.A, self.alpha2, self.dim, self.normal_matvec = p.A, p.alpha2, p.dim, mv
        jp = Op(jp, lambda v: jp.A.T @ (jp.A @ v))
        tp = Op(tp, lambda v: tp.A.T @ (tp.A @ v))
    ref, out = jops.lipschitz_for(jp), ops.lipschitz_for(tp)
    _close(out, ref, 1e-3)
    lam = np.linalg.eigvalsh(A.T.astype(np.float64) @ A).max()
    assert float(out) <= (lam + (0.0 if form == "en_prox" else 1.5)) * (1 + 1e-5)


def test_gram_problem_gap_matches_dense(rng):
    """The Gram form's certificate is the dense one's (to f32 rounding)."""
    A, b, x = _f32(rng, 30, 6), _f32(rng, 30), 0.2 * _f32(rng, 6)
    p = GramLeastSquares.create(A, b, "lasso", alpha1=1.0, device="cpu")
    d = LeastSquares.create(A, b, "lasso", alpha1=1.0, device="cpu")
    _close(ops.lasso_duality_gap(p, torch.from_numpy(x)),
           ops.lasso_duality_gap(d, torch.from_numpy(x)), 1e-4)
