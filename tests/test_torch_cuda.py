"""The CUDA kernels of ``fastoptsolver_tpu_torch`` against their plain
PyTorch twins, on the card (``chip_smoke.py`` phase 3 for pytest users).

Every test takes the ``cuda`` fixture, which skips when torch sees no CUDA
device: run them on a GPU machine with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Tolerances: x to rtol 1e-5/atol 1e-6,
``converged`` identical, ``iters`` within one ``check_every`` burst (the JAX
package's cross-engine ones); the stream sums to 1e-5 of each lane's
absolute sum.
"""
import numpy as np
import pytest
import torch

from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
from fastoptsolver_tpu_torch.bench import stream
from fastoptsolver_tpu_torch.kernels import fused_solve

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
    res = solve_lasso_batch(A, b, a1, feature_major=True)
    assert fused_solve.LAUNCHES == before + 1 and res.converged.all()
    # what the kernel refuses goes to the driver, still on the card
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, adaptive_restart=True)
    res = solve_lasso_batch(A, b, a1, cfg=cfg, feature_major=True)
    assert fused_solve.LAUNCHES == before + 1 and res.x.is_cuda


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
