"""The plain reference at a tiny size on the CPU: its gap, its optimum, its
TF32 rounding, and the control that the comparison must call wrong."""
import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.checks import lasso as check
from benchmark.reference import lasso


def _problem(seed=0, n=6, m=40, B=8):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((n, m, B), generator=g, dtype=torch.float64)
    b = torch.randn((m, B), generator=g, dtype=torch.float64) + 3.0
    a1 = 0.2 * torch.stack([(A[k] * b).sum(0) for k in range(n)]).abs().amax(0)
    return A, b, a1


def _cd(A, b, a1, sweeps=20000):
    """Cyclic coordinate descent in float64 NumPy, lane by lane."""
    n, m, B = A.shape
    xs = np.zeros((B, n))
    for j in range(B):
        X, y, lam = A[:, :, j].T.numpy(), b[:, j].numpy(), float(a1[j])
        x, r = np.zeros(n), y.copy()
        for _ in range(sweeps):
            old = x.copy()
            for k in range(n):
                r += X[:, k] * x[k]
                rho = X[:, k] @ r
                x[k] = np.sign(rho) * max(abs(rho) - lam, 0.0) / (X[:, k] @ X[:, k])
                r -= X[:, k] * x[k]
            if np.abs(x - old).max() < 1e-15:
                break
        xs[j] = x
    return torch.from_numpy(xs)


def test_the_optimum_is_coordinate_descents():
    A, b, a1 = _problem()
    lanes = torch.arange(A.shape[2])
    x, f, gap = lasso.optimum(A, b, a1, lanes)
    assert float(gap.max()) <= 1e-12
    x_cd = _cd(A, b, a1)
    torch.testing.assert_close(x, x_cd, rtol=0, atol=1e-9)


def test_the_gap_at_zero_has_its_closed_form():
    A, b, a1 = _problem(1)
    gap, f = lasso.rel_gap(A, b, a1, torch.zeros(A.shape[2], A.shape[0], dtype=torch.float64))
    s = a1 / torch.stack([(A[k] * b).sum(0) for k in range(A.shape[0])]).abs().amax(0)
    torch.testing.assert_close(gap, (1 - s) ** 2)  # ½(1 − s)²‖b‖² over ½‖b‖²
    torch.testing.assert_close(f, 0.5 * (b * b).sum(0))


def test_the_residual_gap_is_the_gram_gap_in_float64():
    A, b, a1 = _problem(2)
    x = torch.randn((A.shape[2], A.shape[0]), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64) * 0.1
    Q, c, btb = lasso.gram(A, b)
    torch.testing.assert_close(lasso.rel_gap(A, b, a1, x)[0],
                               lasso.gram_rel_gap(Q, c, btb, a1, x), rtol=1e-9, atol=1e-12)


def test_rel_gap_reads_inf_on_a_non_finite_lane():
    A, b, a1 = _problem(4)
    x = torch.zeros((A.shape[2], A.shape[0]), dtype=torch.float64)
    x[1, 0] = float("nan")
    gap, _ = lasso.rel_gap(A, b, a1, x)
    assert gap[1] == float("inf") and torch.isfinite(gap[0])


def test_lane_blocks_cover_every_lane_once():
    blocks = lasso.lane_blocks(96, 192, 10000)
    assert blocks[0][0] == 0 and blocks[-1][1] == 10000
    assert all(e == s for (_, e), (s, _) in zip(blocks, blocks[1:]))


@pytest.mark.parametrize("value,rounded", [(1.0 + 2**-12, 1.0), (1.0 + 2**-11, 1.0 + 2**-10),
                                           (1.0 + 3 * 2**-12, 1.0 + 2**-10), (-3.0, -3.0)])
def test_tf32_keeps_ten_mantissa_bits(value, rounded):
    assert float(lasso.tf32(torch.tensor([value], dtype=torch.float32))[0]) == rounded


@pytest.mark.parametrize("cell", ["boston5.bench", "wide96.bench", "boston5.small_batch",
                                  "wide96.high_alpha"])
def test_the_control_is_not_correct(cell):
    """The reference in the program's place one precision below float32
    fails the cell's limits (at a size a test run holds; on the card the
    same holds at the cell's size, PERF.md)."""
    c = spec.cell(cell)
    cfg = c.config
    build = spec.recipe(cfg)
    A, b, a1 = build(torch.Generator().manual_seed(11), 256, m=cfg["m"], n=cfg["n"],
                     **cfg["recipe_params"], **c.traffic["recipe_params"])
    solver = cfg["solver"]
    x, conv, gap, iters = lasso.control(A, b, a1, tol=solver["rel_gap_tol"],
                                        max_iter=solver["max_iter"],
                                        check_every=solver["check_every"])
    numbers = check.readings(A, b, a1, [check.Answer(x, conv, gap, iters)],
                             tol=solver["rel_gap_tol"], seed=11)
    correct, held = check.judge(numbers, c.limits)
    assert not correct, held
