"""The frozen recipes give the port's own bench tensors bit for bit.

The benchmark keeps copies of the port's data recipes so that a later change
to the program cannot move what the benchmark measures; today the copies and
the originals agree exactly. (Tests may import the port; the harness's
recipes and the reference do not.)
"""
import pytest
import torch

from benchmark import spec
from benchmark.recipes import boston_like, gaussian_sparse


def _config(name):
    return spec.cell(f"{name}.bench").config


@pytest.mark.parametrize("seed,batch,m", [(0, 64, 1000), (2**31 + 11, 200, 37), (5, 129, 8)])
def test_boston_like_is_the_headline_recipe(seed, batch, m):
    from fastoptsolver_tpu_torch.bench.headline import build_problems

    cfg = _config("boston5")
    A0, b0, a0 = build_problems(torch.Generator().manual_seed(seed), batch, m)
    A1, b1, a1 = boston_like.build(torch.Generator().manual_seed(seed), batch, m=m, n=cfg["n"],
                                   alpha_scale=0.1, **cfg["recipe_params"])
    assert torch.equal(A0, A1) and torch.equal(b0, b1) and torch.equal(a0, a1)


@pytest.mark.parametrize("seed,batch,m,n", [(0, 64, 192, 96), (2**31 + 11, 130, 12, 6),
                                            (9, 33, 40, 20)])
def test_gaussian_sparse_is_the_wide_n_recipe(seed, batch, m, n):
    from fastoptsolver_tpu_torch.bench.wide_n import build_problems

    cfg = _config("wide96")
    A0, b0, a0 = build_problems(torch.Generator().manual_seed(seed), batch, m, n)
    A1, b1, a1 = gaussian_sparse.build(torch.Generator().manual_seed(seed), batch, m=m, n=n,
                                       alpha_scale=0.1, **cfg["recipe_params"])
    assert torch.equal(A0, A1) and torch.equal(b0, b1) and torch.equal(a0, a1)


def test_alpha_scale_scales_alpha_alone():
    cfg = _config("wide96")
    kw = dict(m=24, n=8, **cfg["recipe_params"])
    A1, b1, a1 = gaussian_sparse.build(torch.Generator().manual_seed(3), 16, alpha_scale=0.1, **kw)
    A5, b5, a5 = gaussian_sparse.build(torch.Generator().manual_seed(3), 16, alpha_scale=0.5, **kw)
    assert torch.equal(A1, A5) and torch.equal(b1, b5)
    torch.testing.assert_close(a5, 5.0 * a1)


def test_boston_like_refuses_another_width():
    with pytest.raises(ValueError, match="5 features"):
        boston_like.build(torch.Generator(), 4, m=10, n=6, noise_grid=[1.0], rho1_grid=[0.5],
                          rho2_grid=[0.5], alpha_scale=0.1)
