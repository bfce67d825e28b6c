"""Wide Gaussian lasso batches with a sparse truth (the wide-n bench's
recipe).

A frozen copy of the port's ``bench/wide_n.py:build_problems`` in plain
PyTorch, with the α₁ scale as a parameter, so that a later change to the
program cannot move the data the benchmark measures. From one
``torch.Generator`` it gives the port's tensors bit for bit
(``benchmark/tests/test_recipes.py``).

Per lane: A ~ N(0, 1/n), a ``density``-sparse x_true with N(0, x_scale²)
entries, ``b = A·x_true + noise_std·N(0, 1)``, α₁ = ``alpha_scale``·‖Aᵀb‖∞.
"""
from __future__ import annotations

import math

import torch


def build(generator: torch.Generator, batch: int, *, m: int, n: int,
          density: float, x_scale: float, noise_std: float, alpha_scale: float):
    """``(A (n, m, batch), b (m, batch), alpha1 (batch,))`` in float32 on
    ``generator``'s device, feature-leading."""
    dev = generator.device
    A = torch.randn((n, m, batch), generator=generator, device=dev)
    A.div_(math.sqrt(n))
    keep = torch.rand((n, batch), generator=generator, device=dev) < density
    x_true = torch.where(keep, x_scale * torch.randn((n, batch), generator=generator,
                                                     device=dev), 0.0)
    b = noise_std * torch.randn((m, batch), generator=generator, device=dev)
    for k in range(n):  # b += A·x_true plane by plane: no (B, m, n) copy
        b.add_(A[k] * x_true[k])
    aty = torch.stack([(A[k] * b).sum(0) for k in range(n)])
    alpha1 = alpha_scale * aty.abs().amax(0)
    return A, b, alpha1
