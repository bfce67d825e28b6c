"""Boston-like correlated-feature lasso batches (the upstream project's
``easy_boston_data.py`` scenario, batched as its headline bench batches it).

A frozen copy of the port's ``bench/headline.py:build_problems`` over
``problems/generators.py:generate_scenario_batch_fm``, in plain PyTorch, so
that a later change to the program cannot move the data the benchmark
measures. From one ``torch.Generator`` it gives the port's tensors bit for
bit (``benchmark/tests/test_recipes.py``).

Per lane: noise, ρ₁ and ρ₂ drawn from the scenario grid; two correlated
2-feature blocks (rooms/crime at ρ₁, tax/age at ρ₂) and an independent
distance feature; ``b = A·x_true + noise``; features standardised per lane
(b is not centred); α₁ = ``alpha_scale``·‖Aᵀb‖∞.
"""
from __future__ import annotations

import torch

X_TRUE = (5.0, 0.0, -0.02, -0.05, 1.5)
BLOCK1_MEAN, BLOCK1_SCALE = (6.0, 0.2), 0.25
BLOCK2_MEAN, BLOCK2_SCALE = (300.0, 60.0), 100.0
DIST_MEAN, DIST_STD = 4.0, 1.0


def build(generator: torch.Generator, batch: int, *, m: int, n: int,
          noise_grid, rho1_grid, rho2_grid, alpha_scale: float):
    """``(A (n, m, batch), b (m, batch), alpha1 (batch,))`` in float32 on
    ``generator``'s device, feature-leading."""
    if n != len(X_TRUE):
        raise ValueError(f"the Boston-like scenario has {len(X_TRUE)} features, not {n}")
    dev = generator.device
    kw = dict(generator=generator, dtype=torch.float32, device=dev)

    def pick(vals):
        idx = torch.randint(len(vals), (batch,), generator=generator, device=dev)
        return torch.tensor(vals, device=dev)[idx]

    noise, rho1, rho2 = pick(noise_grid), pick(rho1_grid), pick(rho2_grid)

    def block(mean, rho, scale):
        z = torch.randn((2, m, batch), **kw)
        rho = rho[None, :]
        c1 = rho * z[0] + torch.sqrt(1.0 - rho * rho) * z[1]
        s = scale ** 0.5
        return torch.stack([z[0] * s + mean[0], c1 * s + mean[1]])

    block1 = block(BLOCK1_MEAN, rho1, BLOCK1_SCALE)
    block2 = block(BLOCK2_MEAN, rho2, BLOCK2_SCALE)
    distance = DIST_MEAN + DIST_STD * torch.randn((1, m, batch), **kw)
    A = torch.cat([block1, block2, distance], dim=0)
    del block1, block2, distance
    b = noise[None, :] * torch.randn((m, batch), **kw)
    for k in range(n):  # b += A·x_true plane by plane: no (n, m, B) temporary
        b.add_(A[k], alpha=X_TRUE[k])
    mu = A.mean(dim=1, keepdim=True)
    sd = A.std(dim=1, keepdim=True, unbiased=False)
    A.sub_(mu).div_(sd)
    alpha1 = alpha_scale * torch.stack([(A[k] * b).sum(0) for k in range(n)]).abs().amax(0)
    return A, b, alpha1
