"""The port's torch driver (``fastoptsolver_tpu_torch.batch.fista_gram``)
held against the JAX driver (``fastoptsolver_tpu.batch.fista_gram``).

Inputs are made with numpy from a seed and handed to both packages; a JAX
``GramBatch`` is carried across with ``convert.gram_batch_from_numpy`` so
both drivers iterate on the identical Gram. Tolerances: float64 — x to rtol
1e-9 with iters/converged/n_iters_total equal (same recurrences, different
summation order only); float32 — x to rtol 1e-5/atol 1e-6 with iters within
one ``check_every`` burst (a gap check riding the tolerance may flip).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch import fista_gram as JF
from fastoptsolver_tpu_torch import convert
from fastoptsolver_tpu_torch.batch import fista_gram as TF

torch.set_num_threads(1)

GB_FIELDS = ("Q", "c", "btb", "alpha1", "alpha2", "L")


def _problem(seed=0, B=48, m=40, n=5, rho=0.7):
    """Batch-major (B, m, n) lasso instances, AR(1) features of correlation
    ``rho``."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n))
    for k in range(1, n):
        A[..., k] = rho * A[..., k - 1] + np.sqrt(1 - rho * rho) * A[..., k]
    xt = np.zeros((B, n))
    xt[:, :2] = rng.normal(size=(B, 2))
    b = np.einsum("bmn,bn->bm", A, xt) + rng.normal(size=(B, m))
    a1 = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    return A, b, a1


def _to_port(gbj, dtype=None):
    return convert.gram_batch_from_numpy(
        *(np.asarray(getattr(gbj, f), dtype) for f in GB_FIELDS))


@pytest.fixture(scope="module")
def grams():
    """JAX GramBatches (float64 and float32; α₂ = 0 and 0.3) and their
    port copies, built once per module. The float32 problem has milder
    correlation: at ρ = 0.7 f32 rounding alone moves x by more than 1e-5."""
    out = {}
    for dtype, rho in ((jnp.float64, 0.7), (jnp.float32, 0.0)):
        A, b, a1 = _problem(rho=rho)
        for a2 in (0.0, 0.3):
            gbj = JF.make_gram_batch(jnp.asarray(A, dtype), jnp.asarray(b, dtype),
                                     jnp.asarray(a1, dtype), a2)
            out[(np.dtype(dtype).name, a2)] = (gbj, _to_port(gbj))
    return out


MODES = {
    "nesterov": dict(),
    "delta": dict(momentum="delta"),
    "adaptive_restart": dict(adaptive_restart=True),
    "fixed_iters": dict(check_every=0, max_iter=120),
    "greedy": dict(momentum="greedy"),
    # the decisive regime (τ₀ = 4/L: every accept/reject has margin); near
    # its boundaries the Armijo recurrence is chaotic (tests/test_kernel_armijo.py)
    "backtracking": dict(backtracking=True, t_init_factor=4.0),
}


def _cfg(**kw):
    base = dict(max_iter=400, check_every=10, rel_gap_tol=1e-6)
    base.update(kw)
    return JF.BatchFISTAConfig(**base)


@pytest.mark.parametrize("a2", [0.0, 0.3])
@pytest.mark.parametrize("mode", list(MODES))
def test_driver_matches_jax_float64(grams, mode, a2):
    gbj, gbt = grams[("float64", a2)]
    cfg = _cfg(**MODES[mode])
    rj = JF.fista_gram_batch(gbj, cfg)
    rt = TF.fista_gram_batch(gbt, convert.config_from_jax(cfg))
    # Armijo: even in the decisive regime a few entries sitting at the
    # soft-threshold kink move by ~1e-9 (|x| ~ 1) under summation-order
    # differences; everything else holds to rtol 1e-9
    atol = 1e-8 if mode == "backtracking" else 1e-12
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=atol)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.failed.numpy(), np.asarray(rj.failed))
    assert int(rt.n_iters_total) == int(rj.n_iters_total)
    np.testing.assert_allclose(rt.rel_gap.numpy(), np.asarray(rj.rel_gap),
                               rtol=1e-7, atol=1e-12)
    # the reference's Armijo recurrence stalls short of 1e-6 on some lanes
    # (a reference behaviour the port reproduces, not a fault)
    if mode not in ("fixed_iters", "backtracking"):
        assert rt.converged.all()


@pytest.mark.parametrize("mode", ["nesterov", "delta"])
def test_driver_matches_jax_float32(grams, mode):
    gbj, gbt = grams[("float32", 0.0)]
    cfg = _cfg(**MODES[mode])
    rj = JF.fista_gram_batch(gbj, cfg)
    rt = TF.fista_gram_batch(gbt, convert.config_from_jax(cfg))
    assert rt.x.dtype == torch.float32
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-6)
    d_iters = np.abs(rt.iters.numpy().astype(np.int64)
                     - np.asarray(rj.iters, np.int64))
    assert d_iters.max() <= cfg.check_every


@pytest.mark.parametrize("mode", ["nesterov", "adaptive_restart", "greedy"])
def test_resume_equals_straight_run(grams, mode):
    """Stopping at k and restarting from ``state0`` is the straight run."""
    _, gbt = grams[("float64", 0.0)]
    cfg = convert.config_from_jax(_cfg(**MODES[mode]))
    straight = TF.fista_gram_batch(gbt, cfg)
    _, mid = TF.fista_gram_batch(gbt, dataclasses.replace(cfg, max_iter=30),
                                 return_state=True)
    assert mid.k == 30
    resumed = TF.fista_gram_batch(gbt, cfg, state0=mid)
    assert torch.equal(resumed.x, straight.x)
    assert torch.equal(resumed.iters, straight.iters)
    assert torch.equal(resumed.converged, straight.converged)
    assert resumed.n_iters_total == straight.n_iters_total


def test_resume_from_jax_state(grams):
    """A JAX ``BatchState`` carried over with ``batch_state_from_numpy``
    resumes in the port to the JAX straight run."""
    gbj, gbt = grams[("float64", 0.0)]
    cfg = _cfg()
    _, mid = JF.fista_gram_batch(gbj, _cfg(max_iter=20), return_state=True)
    state = convert.batch_state_from_numpy(*(np.asarray(f) for f in mid))
    rt = TF.fista_gram_batch(gbt, convert.config_from_jax(cfg), state0=state)
    rj = JF.fista_gram_batch(gbj, cfg)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))


@pytest.mark.parametrize("a2", [0.0, 0.3])
def test_make_gram_batch_matches_jax(grams, a2):
    A, b, a1 = _problem()
    gbj, _ = grams[("float64", a2)]
    v0 = np.random.default_rng(5).normal(size=(A.shape[2], A.shape[0]))
    gbt = TF.make_gram_batch(torch.from_numpy(A), torch.from_numpy(b),
                             torch.from_numpy(a1), a2,
                             v0=torch.from_numpy(v0), power_iters=1000)
    for f in ("Q", "c", "btb", "alpha1", "alpha2"):
        np.testing.assert_allclose(getattr(gbt, f).numpy(),
                                   np.asarray(getattr(gbj, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    lam = np.linalg.eigvalsh(np.moveaxis(gbt.Q.numpy(), -1, 0))[:, -1]
    np.testing.assert_allclose(gbt.L.numpy(), lam + a2, rtol=0, atol=1e-6 * lam.max())
    assert gbt.batch == A.shape[0] and gbt.dim == A.shape[2]


def test_make_gram_batch_generator_and_given_L():
    A, b, a1 = _problem(seed=2, B=16)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    g1 = TF.make_gram_batch(At, bt, 0.1, 0.0,
                            generator=torch.Generator().manual_seed(3))
    g2 = TF.make_gram_batch(At, bt, 0.1, 0.0,
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(g1.L, g2.L)  # reproducible from the generator
    L = torch.arange(1.0, 17.0, dtype=torch.float64)
    assert torch.equal(TF.make_gram_batch(At, bt, 0.1, 0.0, L=L).L, L)
    assert torch.equal(TF.make_gram_batch(At, bt, 0.1, 0.0, estimate_l=False).L,
                       torch.ones(16, dtype=torch.float64))
    assert g1.alpha1.shape == (16,)


BAD_CONFIGS = {
    "delta_le_2": dict(momentum="delta", delta=2.0),
    "unknown_momentum": dict(momentum="bogus"),
    "greedy_xi": dict(momentum="greedy", greedy_xi=2.0),
    "backtracking_greedy": dict(momentum="greedy", backtracking=True),
}


@pytest.mark.parametrize("name", list(BAD_CONFIGS))
def test_config_validation_matches_jax(name):
    kw = BAD_CONFIGS[name]
    with pytest.raises(ValueError) as ej:
        JF.BatchFISTAConfig(**kw)
    with pytest.raises(ValueError) as et:
        TF.BatchFISTAConfig(**kw)
    assert str(et.value) == str(ej.value)


def test_config_fields_match_jax():
    cfg = JF.BatchFISTAConfig(max_iter=77, momentum="delta", delta=4.0,
                              backtracking=True)
    assert dataclasses.asdict(convert.config_from_jax(cfg)) == dataclasses.asdict(cfg)
    assert ([f.name for f in dataclasses.fields(TF.BatchFISTAConfig)]
            == [f.name for f in dataclasses.fields(JF.BatchFISTAConfig)])
