"""The fused kernel's plain twin (``fastoptsolver_tpu_torch.kernels``) held
against ``fastoptsolver_tpu.kernels.solve_lasso_fused(..., interpret=True)``
in float32, plus the port's guards, β table, building blocks and stream twin.

Both sides get the same inputs (numpy, from a seed) and the same lane
grouping ``b_tile``: certified lanes keep iterating until their tile exits,
so another grouping gives another x. Tolerances are the JAX package's own
cross-engine ones (tests/test_kernels.py:671-681): x to rtol 1e-5/atol 1e-6,
``converged`` identical, ``iters`` within one ``check_every`` burst.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu.kernels import _common as jc
from fastoptsolver_tpu.kernels import fista_vmem as jvmem
from fastoptsolver_tpu.kernels import gram_build as jgram
from fastoptsolver_tpu.kernels import solve_lasso_fused as jax_fused
from fastoptsolver_tpu_torch import convert
from fastoptsolver_tpu_torch.batch import BatchFISTAConfig
from fastoptsolver_tpu_torch.bench import stream
from fastoptsolver_tpu_torch.kernels import _common as tc
from fastoptsolver_tpu_torch.kernels import fista_vmem as tvmem
from fastoptsolver_tpu_torch.kernels import fused_solve
from fastoptsolver_tpu_torch.kernels import gram_build as tgram

torch.set_num_threads(1)


def _problem(n, m, B, seed, rho=0.2):
    """Feature-leading f32 lasso instances, AR(1) features of correlation
    ``rho`` (mild: f32 rounding then moves x well under 1e-5)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):
        A[k] = rho * A[k - 1] + np.sqrt(1 - rho * rho) * A[k]
    xt = np.zeros((n, B))
    xt[: max(n // 2, 1)] = rng.normal(size=(max(n // 2, 1), B))
    b = np.einsum("nmb,nb->mb", A, xt) + 2.0 * rng.normal(size=(m, B))
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(A), f32(b), f32(a1)


# (shape, momentum, alpha2, b_tile): 4 ragged tiles of 128 lanes (JAX's auto
# mode runs its _overlap_kernel there), and one ragged 256-lane tile
CASES = {
    "nesterov_4tiles": ((5, 250, 390), "nesterov", 0.0, 128),
    "delta_ridge_1tile": ((5, 250, 200), "delta", 0.3, 256),
}


@pytest.fixture(scope="module")
def solved():
    """Both packages' results for every case, computed once."""
    out = {}
    for name, ((n, m, B), mode, a2, bt) in CASES.items():
        A, b, a1 = _problem(n, m, B, seed=len(out))
        cfg = JaxConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6,
                        momentum=mode)
        rj = jax_fused(jnp.asarray(A), jnp.asarray(b), jnp.asarray(a1), a2,
                       cfg=cfg, b_tile=bt, interpret=True)
        rt = fused_solve.solve_lasso_fused(
            torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(a1), a2,
            cfg=convert.config_from_jax(cfg), b_tile=bt, interpret=True)
        out[name] = (rj, rt, cfg)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_fused_kernel(solved, case):
    rj, rt, cfg = solved[case]
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    d_iters = np.abs(rt.iters.numpy().astype(np.int64)
                     - np.asarray(rj.iters, np.int64))
    assert d_iters.max() <= cfg.check_every
    assert rt.converged.all() and not rt.failed.any()
    assert float(rt.rel_gap.max()) <= cfg.rel_gap_tol
    assert rt.x.shape == tuple(np.asarray(rj.x).shape)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_is_deterministic_across_groupings(solved, case):
    """The public twin equals the CPU route of ``solve_lasso_fused``, and a
    finer lane grouping certifies the same lanes to the same tolerance."""
    (n, m, B), mode, a2, bt = CASES[case]
    A, b, a1 = (torch.from_numpy(x) for x in _problem(n, m, B, seed=list(CASES).index(case)))
    _, rt, cfg = solved[case]
    cfg = convert.config_from_jax(cfg)
    again = fused_solve.fused_solve_reference(A, b, a1, a2, cfg=cfg, b_tile=bt)
    assert torch.equal(again.x, rt.x) and torch.equal(again.iters, rt.iters)
    other = fused_solve.fused_solve_reference(A, b, a1, a2, cfg=cfg, b_tile=32)
    assert torch.equal(other.converged, rt.converged)
    assert (other.iters <= rt.iters).all()  # a finer tile never runs longer
    torch.testing.assert_close(other.x, rt.x, rtol=1e-4, atol=1e-5)


def _cfg(**kw):
    return BatchFISTAConfig(**{**dict(max_iter=10, check_every=5), **kw})


GUARDS = {
    "check_every_0": (dict(check_every=0), ValueError),
    "adaptive_restart": (dict(adaptive_restart=True), NotImplementedError),
    "greedy": (dict(momentum="greedy"), NotImplementedError),
    "backtracking": (dict(backtracking=True), NotImplementedError),
    "restart_non_nesterov": (dict(momentum="delta", adaptive_restart=True), ValueError),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_fused_guards(name):
    kw, exc = GUARDS[name]
    A = torch.ones((5, 16, 128))
    b = torch.ones((16, 128))
    with pytest.raises(exc):
        fused_solve.solve_lasso_fused(A, b, 0.1, cfg=_cfg(**kw), interpret=True)


@pytest.mark.parametrize("kw", [dict(state0=object()), dict(return_state=True)])
def test_fused_state_not_ported(kw):
    A = torch.ones((5, 16, 128))
    with pytest.raises(NotImplementedError, match="FusedSolveState"):
        fused_solve.solve_lasso_fused(A, torch.ones((16, 128)), 0.1,
                                      cfg=_cfg(), interpret=True, **kw)


def test_envelope_and_launch_checks():
    assert fused_solve.auto_tiles_fused(5, 1000) == (128, 1000)
    assert fused_solve.auto_tiles_fused(fused_solve.MAX_N, 7)[1] == 7
    with pytest.raises(ValueError, match="torch driver"):
        fused_solve.auto_tiles_fused(fused_solve.MAX_N + 1, 100)
    # the CUDA wrapper refuses a CPU tensor before anything is built
    A = torch.ones((5, 16, 128))
    with pytest.raises(ValueError, match="CUDA"):
        fused_solve._launch(A, torch.ones((16, 128)), torch.ones(128),
                            torch.zeros(128), torch.zeros(10), b_tile=128,
                            pl_iters=32, l_safety=1.02, t_init=1.0, chunk=5,
                            k_end=10, tol=1e-6)
    with pytest.raises(ValueError, match="scalar or a"):
        fused_solve.solve_lasso_fused(A, torch.ones((16, 128)),
                                      torch.ones(7), cfg=_cfg())


@pytest.mark.parametrize("k0, n_steps, mode", [(0, 1000, "nesterov"),
                                               (0, 500, "delta"),
                                               (37, 64, "delta")])
def test_momentum_betas_bitwise(k0, n_steps, mode):
    cfg = JaxConfig(momentum=mode)
    bj, tj = jvmem.momentum_betas(k0, n_steps, 1.0, cfg)
    bt, tt = tvmem.momentum_betas(k0, n_steps, 1.0, convert.config_from_jax(cfg))
    assert bt.dtype == torch.float32
    np.testing.assert_array_equal(bt.numpy().view(np.uint32),
                                  np.asarray(bj).view(np.uint32))
    assert tt == tj


@pytest.mark.parametrize("na", [2, 6, 9])
def test_index_helpers_match_jax(na):
    """``_pairs`` gives the accumulator row order that csrc/fused_solve.cu's
    ``pair_index`` computes; ``_round_up`` pads lanes to whole tiles."""
    pairs = tgram._pairs(na)
    assert pairs == list(jgram._pairs(na))
    assert [i * na - i * (i - 1) // 2 + (k - i) for i, k in pairs] == list(range(len(pairs)))
    for x, mult in ((na, 8), (390, 128), (256, 128), (1, 32)):
        assert tgram._round_up(x, mult) == jgram._round_up(x, mult)


@pytest.mark.parametrize("kw", [{}, dict(backtracking=True),
                                dict(backtracking=True, armijo_c=0.3, ls_eta=3.0,
                                     max_backtracks=7)])
def test_armijo_static_matches_jax(kw):
    cfg = JaxConfig(**kw)
    assert tvmem._armijo_static(convert.config_from_jax(cfg)) == jvmem._armijo_static(cfg)


def test_building_blocks_match_jax_common():
    """augmented_gram, power_lambda_max and gram_rel_gap against the JAX
    helpers, which also run on plain arrays."""
    A, b, a1 = (x.astype(np.float64) for x in _problem(4, 60, 32, seed=7))
    At, bt_ = torch.from_numpy(A), torch.from_numpy(b)
    Q, c, btb = tc.augmented_gram(At, bt_)
    np.testing.assert_allclose(Q.numpy(), np.einsum("imb,jmb->ijb", A, A), rtol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.einsum("imb,mb->ib", A, b), rtol=1e-12)
    np.testing.assert_allclose(btb.numpy()[0], (b ** 2).sum(0), rtol=1e-12)
    Qj, cj, btbj = jnp.asarray(Q.numpy()), jnp.asarray(c.numpy()), jnp.asarray(btb.numpy())
    Lt = tc.power_lambda_max(tc.make_matvec(Q, 4), c, 32)
    Lj = jc.power_lambda_max(jc.make_matvec(Qj, 4), cj, 32)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-12)
    X = np.random.default_rng(1).normal(size=(4, 32))
    a1r, a2r = a1[None, :], np.full((1, 32), 0.3)
    for a2 in (np.zeros((1, 32)), a2r):
        gt = tc.gram_rel_gap(torch.from_numpy(X), tc.make_matvec(Q, 4), c,
                             torch.from_numpy(a1r), torch.from_numpy(a2), btb)
        gj = jc.gram_rel_gap(jnp.asarray(X), jc.make_matvec(Qj, 4), cj,
                             jnp.asarray(a1r), jnp.asarray(a2), btbj)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12)


def test_stream_twin_is_full_sum():
    A, b, _ = _problem(5, 70, 130, seed=3)
    want = A.astype(np.float64).sum(axis=(0, 1)) + b.astype(np.float64).sum(axis=0)
    scale = np.abs(A).sum(axis=(0, 1)) + np.abs(b).sum(axis=0)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for got in (stream.stream_pass_reference(At, bt), stream.stream_pass(At, bt)):
        assert got.shape == (130,)
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * scale)
    assert stream.LAUNCHES == 0  # the CPU route never launches the kernel
    with pytest.raises(ValueError, match="CUDA"):
        stream.measure_stream_ceiling(At, bt)
