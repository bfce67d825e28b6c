"""The CUDA kernels of ``fastoptsolver_tpu_torch`` against their plain
PyTorch twins, on the card (``chip_smoke.py`` phase 3 for pytest users):
the fused solve, the stream pass, the Gram build and the burst engine.

Every test takes the ``cuda`` fixture, which skips when torch sees no CUDA
device: run them on a GPU machine with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Tolerances: x to rtol 1e-5/atol 1e-6,
``converged`` identical, ``iters`` within one ``check_every`` burst (the JAX
package's cross-engine ones); the stream sums to 1e-5 of each lane's
absolute sum.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
from fastoptsolver_tpu_torch.bench import stream
from fastoptsolver_tpu_torch.kernels import fista_vmem, fused_solve, gram_build

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _problem(n, m, B, seed, device):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):  # AR(1) features, ρ = 0.2
        A[k] = 0.2 * A[k - 1] + np.sqrt(1 - 0.04) * A[k]
    xt = np.zeros((n, B))
    xt[: max(n // 2, 1)] = rng.normal(size=(max(n // 2, 1), B))
    b = np.einsum("nmb,nb->mb", A, xt) + 2.0 * rng.normal(size=(m, B))
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return t(A), t(b), t(a1)


SHAPES = [(5, 250, 390), (1, 64, 128), (8, 333, 300)]


@pytest.mark.parametrize("mode, a2", [("nesterov", 0.0), ("delta", 0.3)])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_kernel_matches_twin(cuda, shape, mode, a2):
    A, b, a1 = _problem(*shape, seed=SHAPES.index(shape), device=cuda)
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6,
                           momentum=mode)
    before = fused_solve.LAUNCHES
    got = fused_solve.solve_lasso_fused(A, b, a1, a2, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_solve.LAUNCHES == before + 1
    want = fused_solve.fused_solve_reference(A, b, a1, a2, cfg=cfg)
    torch.testing.assert_close(got.x, want.x, rtol=1e-5, atol=1e-6)
    assert torch.equal(got.converged, want.converged)
    assert int((got.iters - want.iters).abs().max()) <= cfg.check_every
    assert got.converged.all()


@pytest.mark.parametrize("shape", SHAPES)
def test_stream_kernel_matches_twin(cuda, shape):
    A, b, _ = _problem(*shape, seed=0, device=cuda)
    before = stream.LAUNCHES
    got = stream.stream_pass(A, b)
    assert stream.LAUNCHES == before + 1
    want = stream.stream_pass_reference(A, b)
    scale = A.abs().sum(dim=(0, 1)) + b.abs().sum(dim=0)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_router_takes_the_kernel_on_cuda(cuda):
    A, b, a1 = _problem(5, 100, 256, seed=4, device=cuda)
    before = fused_solve.LAUNCHES
    builds, bursts = gram_build.LAUNCHES, fista_vmem.LAUNCHES
    res = solve_lasso_batch(A, b, a1, feature_major=True)
    assert fused_solve.LAUNCHES == before + 1 and res.converged.all()
    assert gram_build.LAUNCHES == builds and fista_vmem.LAUNCHES == bursts
    # what the fused kernel refuses goes to the two-kernel path: two build
    # launches and one burst launch per check_every iterations
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, adaptive_restart=True)
    res = solve_lasso_batch(A, b, a1, cfg=cfg, feature_major=True)
    assert fused_solve.LAUNCHES == before + 1 and res.x.is_cuda
    assert gram_build.LAUNCHES == builds + 2
    assert fista_vmem.LAUNCHES == bursts + int(res.n_iters_total) // 25
    assert res.converged.all()
    # and past the burst window, to the torch driver on the card
    A, b, a1 = _problem(110, 220, 64, seed=5, device=cuda)
    res = solve_lasso_batch(A, b, a1, feature_major=True)
    assert isinstance(res.n_iters_total, int) and res.x.is_cuda
    assert gram_build.LAUNCHES == builds + 2


@pytest.mark.parametrize("shape", [(9, 33, 300), (20, 70, 200), (64, 128, 256)])
def test_build_kernels_match_twin(cuda, shape):
    A, b, _ = _problem(*shape, seed=6, device=cuda)
    before = gram_build.LAUNCHES
    got = gram_build._launch(A, b, 96)
    torch.cuda.synchronize()
    assert gram_build.LAUNCHES == before + 2
    want = gram_build.gram_build_reference(A, b, 96)
    scale = torch.maximum(want[0].abs().amax(dim=(0, 1)), want[2])
    for g, w in zip(got[:3], want[:3]):
        assert bool(((g - w).abs() <= 1e-5 * scale).all())
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
    assert torch.equal(got[0], got[0].transpose(0, 1))


BURST_MODES = {
    "nesterov": (dict(), 0.0), "delta_ridge": (dict(momentum="delta"), 0.3),
    "restart": (dict(adaptive_restart=True), 0.0), "greedy": (dict(momentum="greedy"), 0.0),
}


@pytest.mark.parametrize("mode", list(BURST_MODES))
def test_burst_kernel_matches_twin(cuda, mode):
    """Fixed runs (check_every=0) to rtol 2e-4/atol 2e-5, certified runs
    (rel_gap_tol 1e-5) with converged identical and iters within a burst."""
    kw, a2 = BURST_MODES[mode]
    A, b, a1 = _problem(20, 150, 300, seed=7, device=cuda)
    gb = gram_build.make_gram_batch_fused(A, b, a1, a2)
    fixed = BatchFISTAConfig(max_iter=100, check_every=0, **kw)
    before = fista_vmem.LAUNCHES
    got = fista_vmem.fista_gram_vmem(gb, fixed)
    torch.cuda.synchronize()
    assert fista_vmem.LAUNCHES == before + 1
    want = fista_vmem.fista_gram_vmem_reference(gb, fixed)
    torch.testing.assert_close(got.x, want.x, rtol=2e-4, atol=2e-5)
    cert = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-5, **kw)
    got = fista_vmem.fista_gram_vmem(gb, cert)
    want = fista_vmem.fista_gram_vmem_reference(gb, cert)
    assert torch.equal(got.converged, want.converged) and got.converged.all()
    assert int((got.iters - want.iters).abs().max()) <= 25


def test_burst_kernel_armijo_decisive_and_resume(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    A = torch.randn((20, 150, 256), generator=g, device=cuda)
    xt = torch.zeros((20, 256), device=cuda)
    xt[:2] = torch.randn((2, 256), generator=g, device=cuda)
    b = torch.einsum("nmb,nb->mb", A, xt).contiguous()
    gb = gram_build.make_gram_batch_fused(A, b, 0.5, 0.0)
    gb = dataclasses.replace(gb, L=gb.L / 4.0)
    cfg = BatchFISTAConfig(max_iter=5, check_every=0, backtracking=True)
    got = fista_vmem.fista_gram_vmem(gb, cfg)
    want = fista_vmem.fista_gram_vmem_reference(gb, cfg)
    torch.testing.assert_close(got.x, want.x, rtol=1e-4, atol=1e-5)
    # resume on the Gram with its true L (at L/4 the fixed step diverges)
    gb = dataclasses.replace(gb, L=gb.L * 4.0)
    full = BatchFISTAConfig(max_iter=100, check_every=0, momentum="greedy")
    straight = fista_vmem.fista_gram_vmem(gb, full)
    _, mid = fista_vmem.fista_gram_vmem(
        gb, BatchFISTAConfig(max_iter=40, check_every=0, momentum="greedy"),
        return_state=True)
    assert torch.isfinite(straight.x).all()
    assert torch.equal(fista_vmem.fista_gram_vmem(gb, full, state0=mid).x, straight.x)


def test_wrapper_refuses_bad_inputs(cuda):
    A, b, a1 = _problem(5, 40, 128, seed=5, device=cuda)
    with pytest.raises(ValueError, match="interpret"):
        fused_solve.solve_lasso_fused(A, b, a1, interpret=True)
    with pytest.raises(ValueError, match="float32"):
        fused_solve.solve_lasso_fused(A.double(), b.double(), a1.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_solve.solve_lasso_fused(A.transpose(1, 2).contiguous().transpose(1, 2), b, a1)
    with pytest.raises(ValueError, match="b_tile"):
        fused_solve.solve_lasso_fused(A, b, a1, b_tile=100)
    with pytest.raises(ValueError, match="interpret"):
        gram_build.make_gram_batch_fused(A, b, a1, 0.0, interpret=True)
    with pytest.raises(ValueError, match="float32"):
        gram_build._launch(A.double(), b.double(), 32)
    gb = gram_build.make_gram_batch_fused(A, b, a1, 0.0)
    with pytest.raises(ValueError, match="interpret"):
        fista_vmem.fista_gram_vmem(gb, interpret=True)
