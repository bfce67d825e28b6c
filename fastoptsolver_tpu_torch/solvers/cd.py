"""Cyclic coordinate descent for L1/elastic-net least squares in Gram form
(port of ``fastoptsolver_tpu/solvers/cd.py``): the framework's
machine-precision oracle (:func:`certified_optimum`) and a solver in its own
right. Each coordinate update is closed-form:

    x_j ← soft_threshold(c_j − Σ_{k≠j} Q_jk x_k, α₁) / (Q_jj + α₂)

A sweep is sequential by nature (each update uses the fresh values), so in
eager torch it is n dependent groups of small ops; sweeps repeat until the
largest coordinate move falls below ``tol``, the move read on the host every
``STOP_EVERY`` sweeps (a stopped state is frozen, so the sweeps past the
stop change nothing).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.prox import soft_threshold
from .common import Metrics, SolveResult, run_loop


@dataclasses.dataclass(frozen=True)
class CDConfig:
    max_sweeps: int = 1000
    tol: float = 1e-12  # stop when max coordinate move < tol


class CDState(NamedTuple):
    x: torch.Tensor
    max_move: torch.Tensor
    k: torch.Tensor


def cd_sweep(Q: torch.Tensor, c: torch.Tensor, alpha1, alpha2, x: torch.Tensor) -> torch.Tensor:
    """One cyclic sweep; returns the updated iterate (``x`` is not changed)."""
    x = x.clone()
    for j in range(x.shape[0]):
        qj = Q[j]
        # partial residual: c_j − Σ_{k≠j} Q_jk x_k  =  c_j − (Q_j·x) + Q_jj x_j
        rho = c[j] - qj @ x + qj[j] * x[j]
        x[j] = soft_threshold(rho, alpha1) / (qj[j] + alpha2)
    return x


def cd(problem, config: CDConfig = CDConfig(), x0: torch.Tensor | None = None) -> SolveResult:
    """Solve a Gram-form (or dense, converted) least-squares problem to
    machine precision by cyclic CD."""
    gram = problem if hasattr(problem, "Q") else problem.to_gram()
    Q, c, a1, a2 = gram.Q, gram.c, gram.alpha1, gram.alpha2
    x = gram.x0() if x0 is None else x0

    def sweep(s: CDState) -> CDState:
        x_new = cd_sweep(Q, c, a1, a2, s.x)
        return CDState(x=x_new, max_move=torch.amax(torch.abs(x_new - s.x)), k=s.k + 1)

    init = CDState(x=x, max_move=torch.full((), float("inf"), dtype=x.dtype, device=x.device),
                   k=torch.zeros((), dtype=torch.int32, device=x.device))
    final = run_loop(sweep, init, config.max_sweeps, lambda s: s.max_move >= config.tol)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    z = torch.zeros((), dtype=torch.int32, device=x.device)
    return SolveResult(x=final.x, n_iters=final.k, L=zero, final_tau=zero,
                       metrics=Metrics(n_grad_evals=final.k * x.shape[0],
                                       n_ls_calls=z, ls_iters_total=z))


def certified_optimum(problem, config: CDConfig = CDConfig()):
    """(x*, f*) oracle: CD to machine precision, then the objective."""
    res = cd(problem, config)
    return res.x, problem.objective(res.x)
