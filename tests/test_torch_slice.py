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
from fastoptsolver_tpu_torch.kernels import fista_gram_vmem, fused_solve, make_gram_batch_fused
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
    """Under interpret=True restart, greedy and Armijo at n = 5 run on the
    fused twin, as the reference routes them (every mode at n <= 8); what
    the fused guards refuse, n = 9, goes to the two-kernel path (the build
    and burst twins). backend='kernel' runs the same; without a CUDA tensor
    or interpret, auto falls back to the driver."""
    kw = {"restart": dict(adaptive_restart=True), "greedy": dict(momentum="greedy"),
          "backtracking": dict(backtracking=True), "wide_n": {}}[case]
    A, b = _small(n=fused_solve.MAX_N + 1 if case == "wide_n" else 5)
    cfg = BatchFISTAConfig(max_iter=200, check_every=10, **kw)
    got = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg, interpret=True)
    A_fm, b_fm = A.permute(2, 1, 0).contiguous(), b.T.contiguous()
    if case == "wide_n":
        want = fista_gram_vmem(make_gram_batch_fused(A_fm, b_fm, 0.5, 0.0), cfg)
    else:
        want = fused_solve.fused_solve_reference(A_fm, b_fm, 0.5, 0.0, cfg=cfg)
    assert torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)
    forced = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg, backend="kernel", interpret=True)
    assert torch.equal(forced.x, want.x)
    drv = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg)
    assert torch.equal(drv.x, fista_gram_batch(make_gram_batch(A, b, 0.5, 0.0), cfg).x)


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


@pytest.mark.parametrize("kw, exc, match", [
    # a mesh that is no torch.distributed DeviceMesh
    pytest.param(dict(mesh=object()), TypeError, "mesh must be a torch.distributed "
                 "DeviceMesh", id="kw0-mesh"),
    # a state of no known engine raises TypeError, as in the reference
    pytest.param(dict(state0=object()), TypeError, "state0 must be", id="kw1-resume"),
    # the fused engine's state (n = 5): returned now, once a refusal
    pytest.param(dict(return_state=True, interpret=True), None,
                 "FusedSolveState", id="kw2-resume"),
])
def test_router_unported_options_raise(kw, exc, match):
    A, b = _small()
    if exc is None:
        res, state = solve_lasso_batch(A, b, 0.5, **kw)
        assert type(state).__name__ == match and torch.equal(state.X.T, res.x)
        return
    with pytest.raises(exc, match=match):
        solve_lasso_batch(A, b, 0.5, **kw)


def test_mesh_axis_without_mesh_is_ignored():
    """The reference reads ``mesh_axis`` only with a mesh: without one the
    call is the plain single-device solve, bit for bit."""
    A, b = _small()
    cfg = BatchFISTAConfig(max_iter=200, check_every=10)
    runs = [solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg,
                              key=torch.Generator().manual_seed(0), **kw)
            for kw in ({}, dict(mesh_axis="batch"))]
    for name in ("x", "converged", "rel_gap", "iters"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name)), name


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
    """Every module of the port imports with JAX and the JAX package
    blocked (an import of either raises), and adds neither."""
    modules = sorted(
        ".".join(("fastoptsolver_tpu_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    assert {"fastoptsolver_tpu_torch.batch.cv", "fastoptsolver_tpu_torch.batch.path",
            "fastoptsolver_tpu_torch.ops.lipschitz", "fastoptsolver_tpu_torch.ops.gap",
            "fastoptsolver_tpu_torch.ops.objective", "fastoptsolver_tpu_torch.problems.base",
            "fastoptsolver_tpu_torch.problems.least_squares",
            "fastoptsolver_tpu_torch.bench.headline", "fastoptsolver_tpu_torch.api",
            "fastoptsolver_tpu_torch.compat", "fastoptsolver_tpu_torch.bench.large_lasso",
            "fastoptsolver_tpu_torch.problems.generators",
            "fastoptsolver_tpu_torch.problems.streaming",
            "fastoptsolver_tpu_torch.solvers.gram_dense",
            "fastoptsolver_tpu_torch.bench.streaming_lasso",
            "fastoptsolver_tpu_torch.bench.ablate", "fastoptsolver_tpu_torch.utils",
            "fastoptsolver_tpu_torch.utils.checkpoint",
            "fastoptsolver_tpu_torch.utils.profiling", "fastoptsolver_tpu_torch.utils.pytree",
            "fastoptsolver_tpu_torch.runtime", "fastoptsolver_tpu_torch.runtime.host",
            "fastoptsolver_tpu_torch.kernels.pipeline", "fastoptsolver_tpu_torch.bench.scaling",
            "fastoptsolver_tpu_torch.bench.sweep", "fastoptsolver_tpu_torch.bench.verify_tpu"} | {
        f"fastoptsolver_tpu_torch.parallel.{m}" for m in (
            "mesh", "matvec", "problem", "admm", "multihost", "lanes")} | {
        f"fastoptsolver_tpu_torch.solvers.{m}" for m in (
            "common", "ista", "fista", "cd", "lbfgs", "owlqn", "admm", "svrg", "saga")
    } <= set(modules)
    code = f"""
import importlib, sys
BLOCKED = ("jax", "jaxlib", "fastoptsolver_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
for k in [k for k in sys.modules if k.split(".")[0] in BLOCKED]:
    del sys.modules[k]
sys.meta_path.insert(0, Block())
for mod in {modules!r}:
    importlib.import_module(mod)
print(sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED))
"""
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


def test_kernel_backend_runs_past_the_fused_envelope():
    """The router keys on the kernel engines' guards (plan_gram_solve), not
    the fused kernel's: n = 9 under backend='kernel', interpret=True runs the
    two-kernel twins (it raised before), while n <= 8 with fixed momentum
    still prefers the fused kernel."""
    cfg = BatchFISTAConfig(max_iter=200, check_every=10)
    A, b = _small(n=9)
    got = solve_lasso_batch(A, b, 0.5, 0.0, cfg=cfg, backend="kernel", interpret=True)
    gb = make_gram_batch_fused(A.permute(2, 1, 0).contiguous(), b.T.contiguous(), 0.5, 0.0)
    assert torch.equal(got.x, fista_gram_vmem(gb, cfg).x)
    A8, b8 = _small(n=8)
    fused = solve_lasso_batch(A8, b8, 0.5, 0.0, cfg=cfg, backend="kernel", interpret=True)
    twin = fused_solve.fused_solve_reference(A8.permute(2, 1, 0).contiguous(),
                                             b8.T.contiguous(), 0.5, 0.0, cfg=cfg)
    assert torch.equal(fused.x, twin.x)


def _wide_inputs(n=20, m=150, B=256, seed=5):
    """Feature-leading f32 instances, AR(1) features (ρ = 0.2) and noise 2:
    the f32 gap floor sits well below 1e-6 on these."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):
        A[k] = 0.2 * A[k - 1] + np.sqrt(1 - 0.04) * A[k]
    xt = np.zeros((n, B))
    xt[: n // 2] = rng.normal(size=(n // 2, B))
    b = np.einsum("nmb,nb->mb", A, xt) + 2.0 * rng.normal(size=(m, B))
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(A), f32(b), f32(a1)


@pytest.fixture(scope="module")
def wide_pair():
    """n = 20 through the port's routed surface (the two-kernel twins) and
    through the same composition in JAX: the Pallas build, then the Pallas
    burst engine, both in interpret mode."""
    from fastoptsolver_tpu.kernels import fista_gram_vmem as jax_vmem
    from fastoptsolver_tpu.kernels import make_gram_batch_fused as jax_build

    A, b, a1 = _wide_inputs()
    gbj = jax_build(jnp.asarray(A), jnp.asarray(b), jnp.asarray(a1), 0.0, interpret=True)
    rj = jax_vmem(gbj, JaxConfig(**CFG), interpret=True)
    rt = solve_lasso_batch(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(a1),
                           0.0, cfg=BatchFISTAConfig(**CFG), feature_major=True,
                           interpret=True)
    return rj, rt


def test_two_kernel_slice_matches_jax(wide_pair):
    rj, rt = wide_pair
    assert rt.x.shape == (256, 20) and not isinstance(rt.n_iters_total, int)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    d_iters = np.abs(rt.iters.numpy().astype(np.int64) - np.asarray(rj.iters, np.int64))
    assert d_iters.max() <= CFG["check_every"]
    assert rt.converged.all() and float(rt.rel_gap.max()) <= CFG["rel_gap_tol"]


def _route_of(res):
    """'driver' for the torch driver's scalar k, else 'kernel'."""
    return "driver" if isinstance(res.n_iters_total, int) else "kernel"


@pytest.mark.parametrize("backend, interpret, route", [
    ("auto", False, "driver"), ("auto", True, "kernel"), ("xla", True, "driver"),
    ("kernel", True, "kernel"), ("kernel", False, ValueError)])
def test_solve_gram_batch_routes_like_jax(backend, interpret, route):
    from fastoptsolver_tpu.batch import solve_gram_batch as jax_sgb
    from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
    from fastoptsolver_tpu_torch.batch import solve_gram_batch

    A, b = _small()
    gbt = make_gram_batch(A, b, 0.5, 0.0)
    gbj = JaxGramBatch(*(jnp.asarray(v.numpy()) for v in (
        gbt.Q, gbt.c, gbt.btb, gbt.alpha1, gbt.alpha2, gbt.L)))
    cfg = BatchFISTAConfig(max_iter=200, check_every=10)
    if route is ValueError:
        with pytest.raises(ValueError, match="backend='kernel' unsupported here"):
            jax_sgb(gbj, JaxConfig(max_iter=200, check_every=10), backend=backend,
                    interpret=interpret)
        with pytest.raises(ValueError, match="backend='kernel' unsupported here"):
            solve_gram_batch(gbt, cfg, backend=backend, interpret=interpret)
        return
    got = solve_gram_batch(gbt, cfg, backend=backend, interpret=interpret)
    assert _route_of(got) == route
    want = (fista_gram_batch(gbt, cfg) if route == "driver"
            else fista_gram_vmem(gbt, cfg, interpret=True))
    assert torch.equal(got.x, want.x)


def test_state0_pins_the_route_like_jax():
    """Each state resumes only on its own engine, with the reference's
    errors; states are built from zeros, since every check fires first."""
    from fastoptsolver_tpu.batch import solve_gram_batch as jax_sgb
    from fastoptsolver_tpu.batch.fista_gram import BatchState as JaxBatchState
    from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
    from fastoptsolver_tpu.kernels import FusedSolveState as JaxFusedState
    from fastoptsolver_tpu.kernels import VmemSolveState as JaxVmemState
    from fastoptsolver_tpu_torch.batch import BatchState, GramBatch, solve_gram_batch
    from fastoptsolver_tpu_torch.kernels import FusedSolveState, VmemSolveState

    n, B = 5, 4
    z = lambda *s: np.zeros(s, np.float32)
    gbj = JaxGramBatch(*(jnp.asarray(v) for v in (z(n, n, B), z(n, B), z(B), z(B), z(B), z(B) + 1)))
    gbt = GramBatch(*(torch.from_numpy(v) for v in (z(n, n, B), z(n, B), z(B), z(B), z(B), z(B) + 1)))
    vj = JaxVmemState(*([jnp.asarray(z(1))] * 9))
    vt = VmemSolveState(*([torch.zeros(1)] * 9))
    bj = JaxBatchState(*([jnp.asarray(z(1))] * 10))
    bt = BatchState(*([torch.zeros(1)] * 10))
    fj = JaxFusedState(*([jnp.asarray(z(1))] * 9))
    ft = FusedSolveState(*([torch.zeros(1)] * 9))
    cases = [(vj, vt, dict(backend="xla", interpret=True), ValueError, "backend='xla'"),
             (vj, vt, dict(), ValueError, "VmemSolveState"),
             (bj, bt, dict(backend="kernel", interpret=True), ValueError, "backend='kernel'"),
             # a Gram cannot resume the fused engine, which builds its own
             (fj, ft, dict(interpret=True), TypeError, "state0 must be a Resident"),
             (object(), object(), dict(), TypeError, "state0 must be")]
    for sj, st, kw, exc, match in cases:
        with pytest.raises(exc, match=match):
            jax_sgb(gbj, JaxConfig(), state0=sj, **kw)
        with pytest.raises(exc, match=match):
            solve_gram_batch(gbt, BatchFISTAConfig(), state0=st, **kw)


@pytest.mark.parametrize("kw", [dict(adaptive_restart=True), dict(momentum="greedy")])
def test_routed_resume_is_bit_exact(kw):
    """A certified run cut at 40 iterations and resumed through
    solve_lasso_batch's state0 equals the straight run bit for bit, on the
    burst engine (n = 9, a VmemSolveState), on the fused kernel (n = 5, a
    FusedSolveState) and on the driver (a BatchState); each state refuses
    the other engine's backend."""
    full = BatchFISTAConfig(max_iter=300, check_every=10, **kw)
    half = BatchFISTAConfig(max_iter=40, check_every=10, **kw)
    for n, interpret, engine, other in ((9, True, "VmemSolveState", "xla"),
                                        (9, False, "BatchState", "kernel"),
                                        (5, True, "FusedSolveState", "xla")):
        A, b = _small(n=n)
        straight = solve_lasso_batch(A, b, 0.5, 0.0, cfg=full, interpret=interpret)
        _, mid = solve_lasso_batch(A, b, 0.5, 0.0, cfg=half, interpret=interpret,
                                   return_state=True)
        assert type(mid).__name__ == engine
        resumed = solve_lasso_batch(A, b, 0.5, 0.0, cfg=full, interpret=interpret,
                                    state0=mid)
        assert torch.equal(resumed.x, straight.x)
        assert torch.equal(resumed.iters, straight.iters)
        with pytest.raises(ValueError, match=f"backend='{other}'"):
            solve_lasso_batch(A, b, 0.5, 0.0, cfg=full, interpret=True, state0=mid,
                              backend=other)


def test_wide_n_problems_follow_the_recipe():
    """bench/wide_n.build_problems: A ~ N(0, 1/n) feature-leading, a
    10%-sparse x_true with N(0, 9) entries, b = A x_true + 0.1 noise,
    α₁ = 0.1·‖Aᵀb‖∞; run_one measures the card and refuses without one."""
    from fastoptsolver_tpu_torch.bench import wide_n

    n, m, B = 16, 32, 4096
    A, b, a1 = wide_n.build_problems(torch.Generator().manual_seed(0), B, m, n)
    assert A.shape == (n, m, B) and b.shape == (m, B) and a1.shape == (B,)
    assert A.dtype == b.dtype == a1.dtype == torch.float32
    assert abs(float(A.var()) * n - 1.0) < 0.02 and abs(float(A.mean())) < 2e-3
    torch.testing.assert_close(
        a1, 0.1 * torch.einsum("nmb,mb->nb", A, b).abs().amax(0), rtol=1e-5, atol=0)
    g = torch.Generator().manual_seed(0)
    A2, b2, _ = wide_n.build_problems(g, B, m, n)
    assert torch.equal(A, A2) and torch.equal(b, b2)
    # the noise left after the best least-squares fit has std 0.1, and the
    # signal is sparse: about 10% of the features carry it
    x_ls = torch.linalg.lstsq(A.permute(2, 1, 0).double(), b.T.double()[..., None]).solution[..., 0]
    resid = b.T.double() - torch.einsum("bmn,bn->bm", A.permute(2, 1, 0).double(), x_ls)
    assert abs(float(resid.pow(2).sum() / (B * (m - n))) ** 0.5 - 0.1) < 0.005
    share = float((x_ls.abs() > 1.0).double().mean())
    assert 0.05 < share < 0.15
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            wide_n.run_one(8, hbm_gb=1e-3)


def _window_inputs(n, B=16, seed=9):
    """(B, m, n) float32 instances past the burst window: A ~ N(0, 1/n), an
    n/8-sparse signal, noise 0.01, α₁ = 0.1·‖Aᵀb‖∞."""
    rng = np.random.default_rng(seed)
    m = 2 * n + 40
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    xt = np.zeros((B, n))
    xt[:, : n // 8] = rng.normal(size=(B, n // 8))
    b = np.einsum("bmn,bn->bm", A, xt) + 0.01 * rng.normal(size=(B, m))
    a1 = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return f32(A), f32(b), f32(a1)


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


WINDOW_CFG = dict(max_iter=400, check_every=25, rel_gap_tol=1e-5)


@pytest.mark.parametrize("n, engine", [(112, "resident"), (200, "qstream")])
def test_router_takes_the_wide_engines(monkeypatch, n, engine):
    """Under interpret=True, n = 112 runs the resident twin once (the Gram
    built without the power loop, L estimated in-kernel) and n = 200 the
    Q-streaming twin once per burst; both certify every lane."""
    from fastoptsolver_tpu_torch.kernels import qstream, resident

    spies = {"resident": _spy(monkeypatch, resident, "_plain_run"),
             "qstream": _spy(monkeypatch, qstream, "_qstream_burst_reference")}
    A, b, a1 = _window_inputs(n)
    res = solve_lasso_batch(A, b, a1, 0.0, cfg=BatchFISTAConfig(**WINDOW_CFG),
                            interpret=True)
    want = 1 if engine == "resident" else int(res.n_iters_total) // 25
    assert len(spies[engine]) == want and want > 0
    assert not spies["qstream" if engine == "resident" else "resident"]
    assert res.converged.all() and not res.failed.any()
    drv = fista_gram_batch(make_gram_batch(A, b, a1, 0.0), BatchFISTAConfig(**WINDOW_CFG))
    np.testing.assert_allclose(res.x.numpy(), drv.x.numpy(), rtol=2e-3, atol=2e-4)


def test_wide_armijo_takes_the_driver():
    """Armijo past the resident window: the torch driver under auto, a
    raise under backend='kernel', as in the reference."""
    A, b, a1 = _window_inputs(200)
    cfg = BatchFISTAConfig(max_iter=50, check_every=25, backtracking=True)
    res = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, interpret=True)
    assert isinstance(res.n_iters_total, int)  # the driver's scalar k
    with pytest.raises(ValueError, match="backend='kernel' unsupported here"):
        solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, interpret=True, backend="kernel")


def test_resident_route_is_the_shared_recipe():
    """solve_lasso_batch at n = 112 is _solve_resident_routed, and
    solve_gram_batch on the estimate_l=False Gram with est_l_iters=96 gives
    the same x; a routed ResidentSolveState resumes bit-exactly."""
    from fastoptsolver_tpu_torch.batch import api, solve_gram_batch
    from fastoptsolver_tpu_torch.kernels import ResidentSolveState

    A, b, a1 = _window_inputs(112)
    cfg = BatchFISTAConfig(**WINDOW_CFG)
    res = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, interpret=True)
    shared = api._solve_resident_routed(A, b, a1, 0.0, cfg, False, None, True)
    assert torch.equal(res.x, shared.x) and torch.equal(res.iters, shared.iters)
    gb = make_gram_batch(A, b, a1, 0.0, estimate_l=False)
    assert bool((gb.L == 1.0).all())
    got = solve_gram_batch(gb, cfg, interpret=True, est_l_iters=api._RESIDENT_EST_L_ITERS)
    assert torch.equal(got.x, res.x)
    half = BatchFISTAConfig(**{**WINDOW_CFG, "max_iter": 50})
    _, mid = solve_lasso_batch(A, b, a1, 0.0, cfg=half, interpret=True, return_state=True)
    assert isinstance(mid, ResidentSolveState)
    resumed = solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, interpret=True, state0=mid)
    assert torch.equal(resumed.x, res.x) and torch.equal(resumed.iters, res.iters)
    with pytest.raises(ValueError, match="backend='xla'"):
        solve_lasso_batch(A, b, a1, 0.0, cfg=cfg, interpret=True, state0=mid, backend="xla")


def test_resident_build_skips_the_power_steps(monkeypatch):
    """At 104 < n ≤ 118 the resident route's Gram comes from the build
    kernels (their twin here) without their power steps: the L = 1 sentinel,
    and the Gram of the build with them."""
    from fastoptsolver_tpu_torch.batch import api
    from fastoptsolver_tpu_torch.kernels import gram_build

    calls = []
    ref = gram_build.gram_build_reference
    monkeypatch.setattr(gram_build, "gram_build_reference",
                        lambda A, b, pl_iters: calls.append(pl_iters) or ref(A, b, pl_iters))
    A, b, a1 = _window_inputs(112)
    gb = api._build_gram_routed(A, b, a1, 0.0, False, None, True, use_kernel=True,
                                estimate_l=False)
    full = api._build_gram_routed(A, b, a1, 0.0, False, None, True, use_kernel=True)
    assert calls == [0, 96]
    assert bool((gb.L == 1.0).all()) and not bool((full.L == 1.0).all())
    assert torch.equal(gb.Q, full.Q) and torch.equal(gb.c, full.c)


def test_resident_state_on_a_sentinel_gram_needs_est_l():
    """The reference's guard: a ResidentSolveState resumed on an
    estimate_l=False Gram without est_l_iters raises (τ would be t_init/1);
    with est_l_iters it resumes to the routed run's x."""
    from fastoptsolver_tpu_torch.batch import api, solve_gram_batch

    A, b, a1 = _window_inputs(112)
    cfg = BatchFISTAConfig(**WINDOW_CFG)
    gb = make_gram_batch(A, b, a1, 0.0, estimate_l=False)
    _, mid = solve_gram_batch(gb, BatchFISTAConfig(**{**WINDOW_CFG, "max_iter": 50}),
                              interpret=True, return_state=True, est_l_iters=96)
    with pytest.raises(ValueError, match="estimate_l=False sentinel"):
        solve_gram_batch(gb, cfg, interpret=True, state0=mid)
    got = solve_gram_batch(gb, cfg, interpret=True, state0=mid, est_l_iters=96)
    want = api._solve_resident_routed(A, b, a1, 0.0, cfg, False, None, True)
    assert torch.equal(got.x, want.x)


def test_est_l_iters_on_a_fresh_solve():
    """A fault of the reference (ROADMAP Queue 3): its solve_gram_batch
    drops est_l_iters on a fresh solve, so a sentinel-L Gram runs with
    τ = t_init and fails every lane. The port forwards it to the resident
    engine and refuses it on any other route."""
    from fastoptsolver_tpu.batch import solve_gram_batch as jax_sgb
    from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
    from fastoptsolver_tpu_torch.batch import solve_gram_batch

    A, b, a1 = _window_inputs(112)
    gb = make_gram_batch(A, b, a1, 0.0, estimate_l=False)
    cfg = BatchFISTAConfig(**WINDOW_CFG)
    gbj = JaxGramBatch(*(jnp.asarray(v.numpy()) for v in (
        gb.Q, gb.c, gb.btb, gb.alpha1, gb.alpha2, gb.L)))
    rj = jax_sgb(gbj, JaxConfig(**WINDOW_CFG), interpret=True, est_l_iters=96)
    assert not np.asarray(rj.converged).any()
    rt = solve_gram_batch(gb, cfg, interpret=True, est_l_iters=96)
    assert rt.converged.all()
    with pytest.raises(ValueError, match="est_l_iters configures the resident"):
        solve_gram_batch(gb, cfg, est_l_iters=96)  # a CPU tensor: the driver route
