"""Synthetic problem generators (port of
``fastoptsolver_tpu/problems/generators.py``).

Boston-like scenarios: two correlated feature blocks (rooms/crime at ρ₁,
tax/age at ρ₂), an independent distance feature, ``x_true = [5.0, 0.0,
−0.02, −0.05, 1.5]`` and Gaussian response noise. Two tiers:

1. :func:`generate_boston_like` — NumPy, the reference's draw sequence
   (``np.random.default_rng(seed)``), so bit for bit the JAX package's.
2. :func:`generate_scenario`, :func:`generate_scenario_batch` and
   :func:`generate_scenario_batch_fm` — tensors drawn from an explicit
   ``torch.Generator``, so a CUDA generator builds the data on the card.
   torch and ``jax.random`` streams differ, so these give distributional
   parity only, as the reference already says of its own two tiers.
"""
from __future__ import annotations

import numpy as np
import torch

# True coefficients (the reference's easy_boston_data.py:40).
X_TRUE = (5.0, 0.0, -0.02, -0.05, 1.5)

# Feature-block parameters (easy_boston_data.py:26-34).
BLOCK1_MEAN = (6.0, 0.2)       # rooms, crime
BLOCK1_SCALE = 0.25
BLOCK2_MEAN = (300.0, 60.0)    # tax, age
BLOCK2_SCALE = 100.0
DIST_MEAN, DIST_STD = 4.0, 1.0  # independent distance feature

# The reference benchmark's scenario grid (its figures' filenames).
SCENARIO_SEEDS = (0, 1, 2, 3, 4)
SCENARIO_NOISE = (0.5, 1.0, 2.0, 5.0)
SCENARIO_RHO1 = (0.5, 0.8)
SCENARIO_RHO2 = (0.7, 0.9)


def scenario_grid():
    """All 80 (seed, noise_std, rho1, rho2) combinations of the reference sweep."""
    return [(s, n, r1, r2) for s in SCENARIO_SEEDS for n in SCENARIO_NOISE
            for r1 in SCENARIO_RHO1 for r2 in SCENARIO_RHO2]


def generate_boston_like(m: int = 1000, seed: int = 42, noise_std: float = 2.0,
                         rho1: float = 0.8, rho2: float = 0.9):
    """NumPy generator with the reference's draw order, bit for bit.
    Returns ``(A, b, x_true)`` with ``A`` of shape (m, 5)."""
    rng = np.random.default_rng(seed)
    cov1 = np.array([[1.0, rho1], [rho1, 1.0]]) * BLOCK1_SCALE
    block1 = rng.multivariate_normal(list(BLOCK1_MEAN), cov1, size=m)
    cov2 = np.array([[1.0, rho2], [rho2, 1.0]]) * BLOCK2_SCALE
    block2 = rng.multivariate_normal(list(BLOCK2_MEAN), cov2, size=m)
    distance = rng.normal(DIST_MEAN, DIST_STD, size=(m, 1))
    A = np.hstack([block1, block2, distance])
    x_true = np.array(X_TRUE)
    b = A @ x_true + rng.normal(0, noise_std, size=m)
    return A, b, x_true


def _lanes(v, dtype, device, batch=None):
    """A scalar or per-instance hyperparameter as a tensor; with ``batch``,
    broadcast to (batch, 1) against (batch, m)."""
    t = torch.as_tensor(v, dtype=dtype, device=device)
    return t if batch is None else t.expand(batch)[:, None]


def _corr_block(generator: torch.Generator, mean, rho, scale: float, m: int, dtype,
                batch=None):
    """An (m, 2) correlated Gaussian block (or (batch, m, 2)) through the
    2×2 Cholesky factor of ``scale·[[1, ρ], [ρ, 1]]``, in closed form."""
    dev = generator.device
    lead = () if batch is None else (batch,)
    z = torch.randn(lead + (m, 2), generator=generator, dtype=dtype, device=dev)
    rho = _lanes(rho, dtype, dev, batch)
    c0 = z[..., 0]
    c1 = rho * z[..., 0] + torch.sqrt(1.0 - rho * rho) * z[..., 1]
    mean = torch.tensor(mean, dtype=dtype, device=dev)
    return torch.stack([c0, c1], dim=-1) * scale ** 0.5 + mean


def _scenario(generator, batch, m, noise_std, rho1, rho2, dtype):
    dev = generator.device
    lead = () if batch is None else (batch,)
    block1 = _corr_block(generator, BLOCK1_MEAN, rho1, BLOCK1_SCALE, m, dtype, batch)
    block2 = _corr_block(generator, BLOCK2_MEAN, rho2, BLOCK2_SCALE, m, dtype, batch)
    distance = DIST_MEAN + DIST_STD * torch.randn(lead + (m, 1), generator=generator,
                                                  dtype=dtype, device=dev)
    A = torch.cat([block1, block2, distance], dim=-1)
    x_true = torch.tensor(X_TRUE, dtype=dtype, device=dev)
    noise = _lanes(noise_std, dtype, dev, batch) * torch.randn(
        lead + (m,), generator=generator, dtype=dtype, device=dev)
    return A, A @ x_true + noise, x_true


def generate_scenario(generator: torch.Generator, m: int = 1000, noise_std=2.0,
                      rho1=0.8, rho2=0.9, dtype: torch.dtype = torch.float32):
    """One scenario ``(A (m, 5), b (m,), x_true (5,))`` on ``generator``'s device."""
    return _scenario(generator, None, m, noise_std, rho1, rho2, dtype)


def generate_scenario_batch(generator: torch.Generator, batch: int, m: int = 1000,
                            noise_std=2.0, rho1=0.8, rho2=0.9,
                            dtype: torch.dtype = torch.float32):
    """``batch`` independent scenarios in one pass: ``A (batch, m, 5)``,
    ``b (batch, m)``, ``x_true (5,)``; ``noise_std``, ``rho1`` and ``rho2``
    are scalars or (batch,) sequences (per instance)."""
    return _scenario(generator, batch, m, noise_std, rho1, rho2, dtype)


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
