"""Prox-SAGA: incremental variance-reduced proximal gradient (Defazio, Bach
& Lacoste-Julien 2014; port of ``fastoptsolver_tpu/solvers/saga.py``).

For row-separable least squares each row's gradient is rank-1, so the table
is the m scalar residuals φᵢ = aᵢᵀx_old − bᵢ, with its mean kept as
s = Aᵀφ. Average form ĝ(x) = (1/m)Σ ½(aᵢᵀx−bᵢ)² + ½(α₂/m)‖x‖², a step on
prox_{η·h/m}; minibatch ids B:

    v   = (1/|B|)·A_Bᵀ(r_B − φ_B) + s/m + (α₂/m)·x
    x   ← prox(x − ηv, η/m)
    s   ← s + A_Bᵀ(r_B − φ_B);   φ_B ← r_B

Epochs draw their row permutation as ``solvers/svrg.py`` does (an explicit
``torch.Generator``), and the flat-objective flag is read once an epoch.
"""
from __future__ import annotations

import dataclasses

import torch

from .common import Metrics, SolveResult
from .svrg import epoch_blocks, smooth_ridge


@dataclasses.dataclass(frozen=True)
class SAGAConfig:
    epochs: int = 50
    batch: int = 128  # minibatch rows per step
    steps_per_epoch: int = 0  # 0 → one full pass: m // batch
    step_factor: float = 1.0 / 3.0  # η = step_factor / max_i(‖aᵢ‖² + α₂/m)
    tol: float = 1e-10  # stop when epoch objective decrease < tol·max(|f|,1)
    patience: int = 5  # ...for this many consecutive epochs


def prox_saga(problem, config: SAGAConfig = SAGAConfig(), x0: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> SolveResult:
    """Minimize ``½‖Ax−b‖² (+ ½α₂‖x‖²) + h(x)``; ``problem`` exposes ``A``,
    ``b`` and ``prox``. The step comes from the largest row norm (the
    per-piece Lipschitz constant): no power iteration. ``generator``
    defaults to one seeded with 0 on A's device."""
    A, b = problem.A, problem.b
    m, n = A.shape
    dtype, dev = A.dtype, A.device
    a2 = smooth_ridge(problem)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    x = problem.x0() if x0 is None else x0

    batch = min(config.batch, m)
    steps = config.steps_per_epoch or max(m // batch, 1)
    m_f = torch.as_tensor(float(m), dtype=dtype, device=dev)
    L_max = torch.amax(torch.sum(A * A, dim=1)) + a2 / m_f
    eta = torch.as_tensor(config.step_factor, dtype=dtype, device=dev) / L_max
    inv_batch = torch.as_tensor(1.0 / batch, dtype=dtype, device=dev)

    phi = A @ x - b
    s = A.T @ phi
    f = problem.objective(x)
    epoch = flat_count = 0
    for _ in range(config.epochs):
        idx = epoch_blocks(m, steps, batch, generator, dev)
        A_e, b_e = A[idx], b[idx]  # (steps, batch, n): the epoch's rows, once
        for t in range(steps):
            ids, Ab = idx[t], A_e[t]
            r = Ab @ x - b_e[t]
            gdiff = Ab.T @ (r - phi[ids])
            v = inv_batch * gdiff + s / m_f + (a2 / m_f) * x
            x = problem.prox(x - eta * v, eta / m_f)
            phi.index_copy_(0, ids, r)
            s = s + gdiff
        f_new = problem.objective(x)
        flat = bool((f - f_new) <= config.tol * torch.clamp_min(torch.abs(f), 1.0))
        flat_count = flat_count + 1 if flat else 0
        f, epoch = f_new, epoch + 1
        if flat_count >= config.patience:  # frozen from here on
            break
    z = torch.zeros((), dtype=torch.int32, device=dev)
    epochs = torch.full((), epoch, dtype=torch.int32, device=dev)
    return SolveResult(x=x, n_iters=epochs, L=L_max, final_tau=eta,
                       metrics=Metrics(n_grad_evals=epochs * steps, n_ls_calls=z,
                                       ls_iters_total=z))
