"""Synthetic batched lasso scenarios (port of
``fastoptsolver_tpu/problems/generators.py:generate_scenario_batch_fm``).

Boston-like scenarios: two correlated feature blocks (rooms/crime at ρ₁,
tax/age at ρ₂), an independent distance feature, ``x_true = [5.0, 0.0,
−0.02, −0.05, 1.5]`` and Gaussian response noise. Draws come from an explicit
``torch.Generator``, so a CUDA generator builds bench-sized data on the card.
torch and ``jax.random`` streams differ, so this gives distributional parity
only, as the reference already says of its own two generators.
"""
from __future__ import annotations

import torch

# True coefficients (the reference's easy_boston_data.py:40).
X_TRUE = (5.0, 0.0, -0.02, -0.05, 1.5)

# Feature-block parameters (easy_boston_data.py:26-34).
BLOCK1_MEAN = (6.0, 0.2)       # rooms, crime
BLOCK1_SCALE = 0.25
BLOCK2_MEAN = (300.0, 60.0)    # tax, age
BLOCK2_SCALE = 100.0
DIST_MEAN, DIST_STD = 4.0, 1.0  # independent distance feature


def generate_scenario_batch_fm(
    generator: torch.Generator,
    batch: int,
    m: int = 1000,
    noise_std=2.0,
    rho1=0.8,
    rho2=0.9,
    dtype: torch.dtype = torch.float32,
):
    """``batch`` independent instances in the feature-leading layout:
    ``(A, b, x_true)`` with ``A (5, m, batch)``, ``b (m, batch)`` and
    ``x_true (5,)``, on ``generator``'s device. ``noise_std``, ``rho1`` and
    ``rho2`` are scalars or (batch,) tensors (per instance)."""
    device = generator.device
    kw = dict(generator=generator, dtype=dtype, device=device)

    def lanes(v):
        return torch.as_tensor(v, dtype=dtype, device=device).expand(batch)[None, :]

    def block(mean, rho, scale):
        z = torch.randn((2, m, batch), **kw)
        rho = lanes(rho)  # (1, batch), broadcasts over (m, batch)
        c1 = rho * z[0] + torch.sqrt(1.0 - rho * rho) * z[1]
        s = scale ** 0.5
        return torch.stack([z[0] * s + mean[0], c1 * s + mean[1]])

    block1 = block(BLOCK1_MEAN, rho1, BLOCK1_SCALE)
    block2 = block(BLOCK2_MEAN, rho2, BLOCK2_SCALE)
    distance = DIST_MEAN + DIST_STD * torch.randn((1, m, batch), **kw)
    A = torch.cat([block1, block2, distance], dim=0)  # (5, m, batch)
    del block1, block2, distance
    x_true = torch.tensor(X_TRUE, dtype=dtype, device=device)
    b = lanes(noise_std) * torch.randn((m, batch), **kw)
    for k in range(A.shape[0]):  # b += Σ_k A[k]·x_k without an (5, m, B) temporary
        b.add_(A[k], alpha=X_TRUE[k])
    return A, b, x_true
