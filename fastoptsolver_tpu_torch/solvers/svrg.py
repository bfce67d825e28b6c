"""Prox-SVRG: stochastic variance-reduced proximal gradient (Xiao & Zhang
2014; port of ``fastoptsolver_tpu/solvers/svrg.py``), for tall data (m ≫ n):

    epoch s:  μ = ∇g(x̃)                      (one full pass, 2 matvecs)
    inner t:  v = ∇g_B(x) − ∇g_B(x̃) + μ      (minibatch B, 4 small matvecs)
              x ← prox_{ηh}(x − ηv)

Each epoch draws one permutation of the rows (``torch.randperm`` from an
explicit ``torch.Generator``, where the reference splits a ``jax.random``
key, so one seed gives another stream than the reference's), gathers the
permuted rows once, and steps through them in ``(steps, batch)`` blocks.
The convergence flag (a flat objective for ``patience`` epochs, or the
gradient-map tolerance) is read on the host once an epoch: a converged
state is frozen, as the reference's carry is.
"""
from __future__ import annotations

import dataclasses

import torch

from .common import Metrics, SolveResult, norm


@dataclasses.dataclass(frozen=True)
class SVRGConfig:
    epochs: int = 50
    batch: int = 128  # minibatch rows per inner step
    steps_per_epoch: int = 0  # 0 → one full pass: m // batch
    step_factor: float = 0.1  # η = step_factor / L  (L = λmax(AᵀA) + α₂)
    tol: float = 1e-10  # stop when epoch objective decrease < tol·max(|f|,1)
    patience: int = 5  # ...for this many consecutive epochs
    gradmap_tol: float = 0.0  # optional: ‖x − prox(x−∇g(x))‖/η tolerance


def smooth_ridge(problem) -> torch.Tensor:
    """The α₂ of a row-separable problem's smooth part (0 where the problem
    has none, or keeps it in its prox)."""
    a2 = getattr(problem, "alpha2", None)
    if a2 is None or not getattr(problem, "ridge_in_smooth", True):
        return torch.zeros((), dtype=problem.A.dtype, device=problem.A.device)
    return a2


def epoch_blocks(m: int, steps: int, batch: int, generator: torch.Generator, device):
    """One epoch's row ids, a permutation of ``m`` cut to ``(steps, batch)``."""
    perm = torch.randperm(m, generator=generator, device=generator.device)
    return perm[: steps * batch].reshape(steps, batch).to(device)


def prox_svrg(problem, L, config: SVRGConfig = SVRGConfig(), x0: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> SolveResult:
    """Minimize ``½‖Ax−b‖² (+ ½α₂‖x‖²) + h(x)``; ``problem`` exposes ``A``,
    ``b`` and ``prox``; ``L`` is the smooth part's Lipschitz constant.
    ``generator`` defaults to one seeded with 0 on A's device."""
    A, b = problem.A, problem.b
    m, n = A.shape
    dtype, dev = A.dtype, A.device
    a2 = smooth_ridge(problem)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    x = problem.x0() if x0 is None else x0
    L = torch.as_tensor(L, dtype=dtype, device=dev)

    batch = min(config.batch, m)
    steps = config.steps_per_epoch or max(m // batch, 1)
    eta = torch.as_tensor(config.step_factor, dtype=dtype, device=dev) / L
    scale = torch.as_tensor(m / batch, dtype=dtype, device=dev)

    def full_grad(z):
        return A.T @ (A @ z - b) + a2 * z

    f = problem.objective(x)
    epoch = flat_count = 0
    for _ in range(config.epochs):
        idx = epoch_blocks(m, steps, batch, generator, dev)
        A_e, b_e = A[idx], b[idx]  # (steps, batch, n): the epoch's rows, once
        mu = full_grad(x)  # snapshot gradient at the current x
        x_snap = x
        for t in range(steps):
            Ab, bb = A_e[t], b_e[t]
            r_x = Ab @ x - bb
            r_s = Ab @ x_snap - bb
            v = scale * (Ab.T @ (r_x - r_s)) + mu + a2 * (x - x_snap)
            x = problem.prox(x - eta * v, eta)
        f_new = problem.objective(x)
        flat = bool((f - f_new) <= config.tol * torch.clamp_min(torch.abs(f), 1.0))
        flat_count = flat_count + 1 if flat else 0
        f, epoch = f_new, epoch + 1
        done = flat_count >= config.patience
        if config.gradmap_tol > 0.0:
            gm = x - problem.prox(x - eta * full_grad(x), eta)
            done = done or bool(norm(gm) / eta <= config.gradmap_tol)
        if done:  # frozen from here on, as the reference's carry
            break
    z = torch.zeros((), dtype=torch.int32, device=dev)
    epochs = torch.full((), epoch, dtype=torch.int32, device=dev)
    return SolveResult(x=x, n_iters=epochs, L=L, final_tau=eta,
                       metrics=Metrics(n_grad_evals=epochs * (1 + 2 * steps),
                                       n_ls_calls=z, ls_iters_total=z))
