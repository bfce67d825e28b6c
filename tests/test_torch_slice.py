"""The ported slice as a whole: ``solve_lasso_batch`` of both packages on the
same bench-shaped inputs, the port's router, its generator, and that the
port imports no JAX.

Bench-shaped inputs: n=5, m=1000, B=128 (one lane tile on both sides, so the
groupings match), made in numpy with bench.py's recipe — per-instance noise
and ρ from the reference grid, features standardised per instance, α₁ =
0.1·‖Aᵀb‖∞. ``converged`` identical and ``iters`` within one
``check_every`` burst, as in tests/test_torch_fused_solve.py. The bench data
are correlated (ρ up to 0.9), and on them f32 rounding of the Gram alone
moves x by more than the 1e-6 atol that better-conditioned shapes are held
to: by 7.9e-6 on seed 0, the parity test's inputs, and by ~5e-4 on seeds 1
and 2 (:func:`test_gram_rounding_moves_x_on_bench_inputs`). The packages
differ by 6.3e-6 on seed 0, so x is held at rtol 1e-5 and atol ``X_ATOL``
= 1e-5, just above it, and the lasso objective to 1e-6 relative: each side's
certificate bounds its objective to 1e-6·max(f, 1) above the optimum.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch import solve_lasso_batch as jax_solve
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu_torch.batch import (
    BatchFISTAConfig,
    fista_gram_batch,
    make_gram_batch,
    solve_lasso_batch,
)
from fastoptsolver_tpu_torch.kernels import fused_solve
from fastoptsolver_tpu_torch.problems import X_TRUE, generate_scenario_batch_fm

torch.set_num_threads(1)

PORT = Path(__file__).resolve().parents[1] / "fastoptsolver_tpu_torch"
CFG = dict(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
X_ATOL = 1e-5  # just above max|dx| = 6.3e-6 between the packages on seed 0


def _bench_inputs(B=128, m=1000, seed=0):
    """bench.py:_build_problems in numpy (feature-leading, float32)."""
    rng = np.random.default_rng(seed)
    noise = rng.choice([0.5, 1.0, 2.0, 5.0], B)
    rho1, rho2 = rng.choice([0.5, 0.8], B), rng.choice([0.7, 0.9], B)

    def block(mean, rho, scale):
        z = rng.normal(size=(2, m, B))
        c1 = rho * z[0] + np.sqrt(1 - rho * rho) * z[1]
        return np.stack([z[0], c1]) * np.sqrt(scale) + np.asarray(mean)[:, None, None]

    A = np.concatenate([block((6.0, 0.2), rho1, 0.25),
                        block((300.0, 60.0), rho2, 100.0),
                        4.0 + rng.normal(size=(1, m, B))])
    b = np.einsum("nmb,n->mb", A, np.asarray(X_TRUE)) + noise * rng.normal(size=(m, B))
    A = (A - A.mean(axis=1, keepdims=True)) / A.std(axis=1, keepdims=True)
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(A), f32(b), f32(a1)


@pytest.fixture(scope="module")
def bench_pair():
    A, b, a1 = _bench_inputs()
    rj = jax_solve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(a1), 0.0,
                   cfg=JaxConfig(**CFG), feature_major=True, interpret=True)
    rt = solve_lasso_batch(torch.from_numpy(A), torch.from_numpy(b),
                           torch.from_numpy(a1), 0.0,
                           cfg=BatchFISTAConfig(**CFG), feature_major=True,
                           interpret=True)
    return rj, rt


def _objective64(x, seed=0):
    A, b, a1 = (v.astype(np.float64) for v in _bench_inputs(seed=seed))
    r = np.einsum("nmb,bn->mb", A, np.asarray(x, np.float64)) - b
    return 0.5 * (r * r).sum(axis=0) + a1 * np.abs(np.asarray(x, np.float64)).sum(axis=1)


def _rel_dobj(x1, x2, seed=0):
    f1, f2 = _objective64(x1, seed), _objective64(x2, seed)
    return np.max(np.abs(f1 - f2) / np.maximum(f2, 1.0))


def test_slice_matches_jax_on_bench_inputs(bench_pair):
    rj, rt = bench_pair
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5, atol=X_ATOL)
    assert _rel_dobj(rt.x.numpy(), np.asarray(rj.x)) <= 1e-6
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    d_iters = np.abs(rt.iters.numpy().astype(np.int64) - np.asarray(rj.iters, np.int64))
    assert d_iters.max() <= CFG["check_every"]


@pytest.mark.parametrize("seed, floor", [(0, 1e-6), (1, 1e-4), (2, 1e-4)])
def test_gram_rounding_moves_x_on_bench_inputs(monkeypatch, seed, floor):
    """The port's twin against itself with the Gram accumulated in float64
    (then rounded to f32): f32 rounding of the Gram alone moves x by more
    than ``floor``, while the objectives agree to 1e-6 relative. This is why
    x is held at ``X_ATOL`` above and only the objective at the bench shape
    on the card."""
    args = [torch.from_numpy(v) for v in _bench_inputs(seed=seed)] + [0.0]
    kw = dict(cfg=BatchFISTAConfig(**CFG), feature_major=True, interpret=True)
    r32 = solve_lasso_batch(*args, **kw)
    gram = fused_solve.augmented_gram
    monkeypatch.setattr(fused_solve, "augmented_gram", lambda A, b: tuple(
        t.float() for t in gram(A.double(), b.double())))
    r64 = solve_lasso_batch(*args, **kw)
    assert float((r32.x - r64.x).abs().max()) > floor
    assert _rel_dobj(r32.x.numpy(), r64.x.numpy(), seed) <= 1e-6
    assert r32.converged.all() and r64.converged.all()


def test_slice_certifies_bench_inputs(bench_pair):
    _, rt = bench_pair
    assert rt.x.shape == (128, 5) and torch.isfinite(rt.x).all()
    assert rt.converged.all() and not rt.failed.any()
    assert float(rt.rel_gap.max()) <= CFG["rel_gap_tol"]


def _small(seed=0, n=5, m=30, B=20):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n))
    b = A[..., 0] * 2.0 + rng.normal(size=(B, m))
    return torch.from_numpy(A), torch.from_numpy(b)


def test_router_cpu_auto_runs_driver():
    A, b = _small()
    cfg = BatchFISTAConfig(max_iter=300, check_every=10)
    got = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg)
    want = fista_gram_batch(make_gram_batch(A, b, 0.5, 0.0), cfg)
    assert isinstance(got.n_iters_total, int)  # the driver's scalar k
    assert torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)
    # feature-major input gives the same driver result
    fm = solve_lasso_batch(A.permute(2, 1, 0), b.T, 0.5, 0.0, cfg=cfg,
                           feature_major=True)
    assert torch.equal(fm.x, got.x)


@pytest.mark.parametrize("case", ["restart", "greedy", "backtracking", "wide_n"])
def test_router_auto_falls_back_to_driver(case):
    """What the fused guards refuse goes to the driver under auto, even with
    interpret=True; backend='kernel' raises with the guard's message."""
    kw = {"restart": dict(adaptive_restart=True), "greedy": dict(momentum="greedy"),
          "backtracking": dict(backtracking=True), "wide_n": {}}[case]
    A, b = _small(n=fused_solve.MAX_N + 1 if case == "wide_n" else 5)
    cfg = BatchFISTAConfig(max_iter=200, check_every=10, **kw)
    got = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg, interpret=True)
    want = fista_gram_batch(make_gram_batch(A, b, 0.5, 0.0), cfg)
    assert torch.equal(got.x, want.x)
    with pytest.raises(ValueError, match="backend='kernel' unsupported here"):
        solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg, backend="kernel", interpret=True)


def test_router_kernel_route_and_errors():
    A, b = _small()
    cfg = BatchFISTAConfig(max_iter=200, check_every=10)
    k = solve_lasso_batch(A.float(), b.float(), 0.5, 0.0, cfg=cfg, interpret=True)
    assert not isinstance(k.n_iters_total, int)  # the fused twin's tensor max
    twin = fused_solve.fused_solve_reference(
        A.float().permute(2, 1, 0).contiguous(), b.float().T.contiguous(), 0.5,
        0.0, cfg=cfg)
    assert torch.equal(k.x, twin.x)
    with pytest.raises(ValueError, match="interpret=True"):
        solve_lasso_batch(A, b, 0.5, cfg=cfg, backend="kernel")
    with pytest.raises(ValueError, match="Unknown backend"):
        solve_lasso_batch(A, b, 0.5, cfg=cfg, backend="tpu")
    xla = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg, backend="xla", interpret=True)
    assert isinstance(xla.n_iters_total, int)


@pytest.mark.parametrize("kw, match", [
    (dict(mesh=object()), "mesh"),
    (dict(state0=object()), "resume"),
    (dict(return_state=True), "resume"),
])
def test_router_unported_options_raise(kw, match):
    A, b = _small()
    with pytest.raises(NotImplementedError, match=match):
        solve_lasso_batch(A, b, 0.5, **kw)


def test_generator_shapes_and_block_correlations():
    B, m = 64, 4000
    g = torch.Generator().manual_seed(0)
    rho1 = torch.where(torch.arange(B) % 2 == 0, 0.5, 0.8)
    A, b, x_true = generate_scenario_batch_fm(g, B, m=m, noise_std=1.0,
                                              rho1=rho1, rho2=0.9)
    assert A.shape == (5, m, B) and b.shape == (m, B)
    assert A.dtype == torch.float32 and torch.isfinite(A).all()
    assert x_true.tolist() == pytest.approx(list(X_TRUE))

    def corr(u, v):
        u, v = u - u.mean(0), v - v.mean(0)
        return (u * v).sum(0) / torch.sqrt((u * u).sum(0) * (v * v).sum(0))

    assert (corr(A[0], A[1]) - rho1).abs().max() < 0.05
    assert (corr(A[2], A[3]) - 0.9).abs().max() < 0.05
    assert corr(A[0], A[4]).abs().max() < 0.1  # distance is independent
    resid = b - torch.einsum("nmb,n->mb", A, x_true)
    assert (resid.std(0) - 1.0).abs().max() < 0.05
    A2, _, _ = generate_scenario_batch_fm(torch.Generator().manual_seed(0), B,
                                          m=m, noise_std=1.0, rho1=rho1, rho2=0.9)
    assert torch.equal(A, A2)


def test_import_adds_no_jax_module():
    code = ("import sys; before = set(sys.modules); import fastoptsolver_tpu_torch; "
            "print(sorted(k for k in set(sys.modules) - before "
            "if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'fastoptsolver_tpu.'))))")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_no_port_source_imports_jax():
    offenders = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "fastoptsolver_tpu")]
    assert not offenders
