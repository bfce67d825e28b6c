"""ISTA: proximal gradient descent (port of ``fastoptsolver_tpu/solvers/ista.py``).

Contract kept: step ``t = t_init_factor / L``; Armijo sufficient decrease
``g(x⁺) ≤ g(x) + C·⟨∇g(x), x⁺−x⟩`` with C = 1e-2, η = 0.5, the accepted step
persisting; stop on ``‖x⁺−x‖ < tol`` when ``tol > 0``, otherwise exactly
``max_iter`` iterations. The loop is the host loop of ``solvers.common``;
``generator`` (a ``torch.Generator``) draws the power iteration's start
vector where the reference takes a ``jax.random`` key.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.lipschitz import lipschitz_for
from .common import (
    ARMIJO_C,
    History,
    LineSearchConfig,
    Metrics,
    Run,
    SolveResult,
    armijo_prox_search,
    grad_part,
    norm,
    objective,
    prox_step,
    run_loop,
    tree_where,
)


@dataclasses.dataclass(frozen=True)
class ISTAConfig:
    backtracking: bool = False
    eta: float = 0.5
    t_init_factor: float = 1.0
    max_iter: int = 500
    tol: float = 0.0
    armijo_c: float = ARMIJO_C
    max_backtracks: int = 60
    lipschitz_iters: int = 100
    lipschitz_tol: float = 1e-6

    @property
    def line_search(self) -> LineSearchConfig:
        return LineSearchConfig(backtracking=self.backtracking, eta=self.eta,
                                armijo_c=self.armijo_c,
                                max_backtracks=self.max_backtracks)


class ISTAState(NamedTuple):
    x: torch.Tensor
    tau: torch.Tensor
    k: torch.Tensor
    last_step: torch.Tensor
    done: torch.Tensor


class _Carry(NamedTuple):
    state: ISTAState
    metrics: Metrics


def _ista_step(run: Run, config: ISTAConfig, state: ISTAState, metrics: Metrics):
    x = state.x
    g_x, grad = run(grad_part, x, config.backtracking)
    metrics = metrics._replace(n_grad_evals=metrics.n_grad_evals + 1)
    if config.backtracking:
        x_new, tau, bt_steps = armijo_prox_search(run.problem, x, g_x, grad, state.tau,
                                                  config.line_search, run)
        metrics = metrics._replace(n_ls_calls=metrics.n_ls_calls + 1,
                                   ls_iters_total=metrics.ls_iters_total + bt_steps)
    else:
        tau = state.tau
        x_new = run(prox_step, x, grad, tau)
    delta = norm(x_new - x)
    done = (delta < config.tol) if config.tol > 0.0 else torch.zeros_like(state.done)
    return ISTAState(x=x_new, tau=tau, k=state.k + 1, last_step=delta, done=done), metrics


def ista_step(problem, config: ISTAConfig, state: ISTAState, metrics: Metrics):
    """One ISTA iteration: ``(new_state, new_metrics)``."""
    return _ista_step(Run(problem), config, state, metrics)


def init_state(x: torch.Tensor, tau0) -> ISTAState:
    lead = x.shape[:-1]
    return ISTAState(
        x=x,
        tau=torch.as_tensor(tau0, dtype=x.dtype, device=x.device).expand(lead).clone(),
        k=torch.zeros(lead, dtype=torch.int32, device=x.device),
        last_step=torch.zeros(lead, dtype=x.dtype, device=x.device),
        done=torch.zeros(lead, dtype=torch.bool, device=x.device),
    )


def _prepare(problem, config: ISTAConfig, x0, L, generator):
    if L is None:
        L = lipschitz_for(problem, generator, n_iter=config.lipschitz_iters,
                          tol=config.lipschitz_tol)
    x = problem.x0() if x0 is None else x0
    L = torch.as_tensor(L, dtype=x.dtype, device=x.device)
    return init_state(x, config.t_init_factor / L), L


def _solve(run: Run, config: ISTAConfig, state0: ISTAState, L, history: bool) -> SolveResult:
    """The loop of :func:`ista` / :func:`ista_with_history` on a :class:`Run`
    (one problem or a stack)."""
    carry = _Carry(state0, Metrics.zero(state0.k))
    step = lambda c: _Carry(*_ista_step(run, config, c.state, c.metrics))
    live = lambda c: (c.state.k < config.max_iter) & ~c.state.done
    hist = None
    if not history:
        carry = run_loop(step, carry, config.max_iter, live, stops=config.tol > 0.0)
    else:
        x = state0.x
        lead = x.shape[:-1]
        xs = x.new_empty(lead + (config.max_iter, x.shape[-1]))
        objs = x.new_empty(lead + (config.max_iter,))
        steps, taus = torch.empty_like(objs), torch.empty_like(objs)
        valid = torch.empty(objs.shape, dtype=torch.bool, device=x.device)
        for k in range(config.max_iter):
            on = live(carry)
            carry = tree_where(on, step(carry), carry)
            xs[..., k, :] = carry.state.x
            objs[..., k] = run(objective, carry.state.x)
            steps[..., k] = carry.state.last_step
            valid[..., k] = on
            taus[..., k] = carry.state.tau
        hist = History(x=xs, obj=objs, step_norm=steps, valid=valid, tau=taus)
    return SolveResult(x=carry.state.x, n_iters=carry.state.k, L=L,
                       final_tau=carry.state.tau, metrics=carry.metrics, history=hist)


def ista(problem, config: ISTAConfig = ISTAConfig(), x0: torch.Tensor | None = None,
         L=None, generator: torch.Generator | None = None) -> SolveResult:
    """Solve to ``tol`` or ``max_iter``; ``L`` defaults to the power
    iteration's estimate from ``generator``'s start vector."""
    state0, L = _prepare(problem, config, x0, L, generator)
    return _solve(Run(problem), config, state0, L, history=False)


def ista_with_history(problem, config: ISTAConfig = ISTAConfig(),
                      x0: torch.Tensor | None = None, L=None,
                      generator: torch.Generator | None = None) -> SolveResult:
    """``max_iter`` rows of iterates, objectives, step norms and steps (the
    reference's ``return_history=True`` log)."""
    state0, L = _prepare(problem, config, x0, L, generator)
    return _solve(Run(problem), config, state0, L, history=True)
