"""FISTA / FISTA-Δ: accelerated proximal gradient (port of
``fastoptsolver_tpu/solvers/fista.py``).

One :class:`FISTAState` of tensors advanced by the host loop of
``solvers.common`` (a stop read every ``STOP_EVERY`` steps, none with the
default ``tol = 0``), or a ``max_iter``-row history when one is asked for.
The reference's contract is kept rule for rule:

1. step size ``τ = t_init_factor / L`` with ``L = λ_max(AᵀA) + α₂``;
2. Armijo backtracking with C = 1e-2, η = 0.5; the accepted τ persists and
   never grows;
3. adaptive restart when ``‖x_{k+1}−x_k‖ / ‖x_k−x_{k−1}‖ > threshold``
   (ratio = ∞ on a zero previous step), resetting t = 1, y = x;
4. FISTA-Δ momentum θ_k = k/(k+1+δ) with k counted from 1, δ > 2 enforced;
5. stop rules in the reference's order: the gradient norm *before* the
   proximal update, the step norm after, the step ratio last; all off by
   default (tol = 0 → exactly ``max_iter`` iterations).

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
    objective,
    prox_step,
    run_loop,
    tree_where,
    vnorm,
)


@dataclasses.dataclass(frozen=True)
class FISTAConfig:
    """Solver configuration (frozen, hashable)."""

    backtracking: bool = False
    eta: float = 0.5
    t_init_factor: float = 1.0
    max_iter: int = 500
    tol: float = 0.0
    tol_ratio: float = 0.0
    adaptive_restart: bool = False
    restart_threshold: float = 1.0
    momentum: str = "nesterov"  # "nesterov" | "delta"
    delta: float = 3.0
    armijo_c: float = ARMIJO_C
    max_backtracks: int = 60
    lipschitz_iters: int = 100
    lipschitz_tol: float = 1e-6

    def __post_init__(self):
        if self.momentum not in ("nesterov", "delta"):
            raise ValueError(f"Unknown momentum '{self.momentum}'")
        if self.momentum == "delta" and not self.delta > 2:
            raise ValueError("FISTA-Δ requires delta > 2 for convergence")

    @property
    def line_search(self) -> LineSearchConfig:
        return LineSearchConfig(backtracking=self.backtracking, eta=self.eta,
                                armijo_c=self.armijo_c,
                                max_backtracks=self.max_backtracks)


class FISTAState(NamedTuple):
    x: torch.Tensor  # current iterate x_k
    y: torch.Tensor  # extrapolated point y_k
    t: torch.Tensor  # Nesterov momentum scalar t_k (unused under Δ-momentum)
    tau: torch.Tensor  # current (possibly backtracked) step size
    k: torch.Tensor  # completed proximal updates (int32)
    prev_step: torch.Tensor  # ‖x_k − x_{k−1}‖
    done: torch.Tensor  # bool: a stopping rule fired


def init_state(problem, config: FISTAConfig, x0: torch.Tensor | None, tau0,
               lead: int = 0) -> FISTAState:
    """The state at ``x0`` (or ``problem.x0()``); ``lead`` counts the stacked
    problems' leading axes of the iterate, whose other axes are one problem's."""
    x = problem.x0() if x0 is None else x0
    stack, kw = x.shape[:lead], dict(dtype=x.dtype, device=x.device)
    return FISTAState(
        x=x,
        y=x,
        t=torch.ones(stack, **kw),
        tau=torch.as_tensor(tau0, **kw).expand(stack).clone(),
        k=torch.zeros(stack, dtype=torch.int32, device=x.device),
        prev_step=torch.zeros(stack, **kw),
        done=torch.zeros(stack, dtype=torch.bool, device=x.device),
    )


def _fista_step(run: Run, config: FISTAConfig, state: FISTAState, metrics: Metrics):
    x_k, y_k = state.x, state.y
    lead = state.k.dim()  # the stacked problems' axes; the rest is one iterate
    g_y, grad = run(grad_part, y_k, config.backtracking)
    metrics = metrics._replace(n_grad_evals=metrics.n_grad_evals + 1)

    # Stopping rule 1: gradient norm, checked before the update. Like the
    # reference's static config, a rule that is off costs no ops.
    grad_stop = vnorm(grad, lead) < config.tol if config.tol > 0.0 else None

    if config.backtracking:
        x_next, tau, bt_steps = armijo_prox_search(run.problem, y_k, g_y, grad, state.tau,
                                                   config.line_search, run)
        metrics = metrics._replace(n_ls_calls=metrics.n_ls_calls + 1,
                                   ls_iters_total=metrics.ls_iters_total + bt_steps)
    else:
        tau = state.tau
        x_next = run(prox_step, y_k, grad, tau)

    this_step = vnorm(x_next - x_k, lead)
    ratio = None
    if config.adaptive_restart or config.tol_ratio > 0.0:
        ratio = torch.where(state.prev_step > 0.0,
                            this_step / torch.clamp_min(state.prev_step, 1e-38),
                            torch.full_like(this_step, float("inf")))
    # a per-problem scalar (0-d, or (B,) over a stack) against the iterate
    col = lambda s: s.reshape(s.shape + (1,) * (x_k.dim() - s.dim()))

    if config.momentum == "delta":
        k_ref = (state.k + 1).to(x_k.dtype)  # the reference counts k from 1
        theta = k_ref / (k_ref + 1.0 + config.delta)
        y_next = x_next + col(theta) * (x_next - x_k)
        t_curr = state.t
    else:
        t_curr = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.t ** 2))
        beta = (state.t - 1.0) / t_curr
        y_next = x_next + col(beta) * (x_next - x_k)
        if config.adaptive_restart:
            restart = ratio > config.restart_threshold
            t_curr = torch.where(restart, torch.ones_like(t_curr), t_curr)
            y_next = torch.where(col(restart), x_next, y_next)

    # Stopping rules 2 and 3 (post-update).
    done = torch.zeros_like(state.done)
    if config.tol > 0.0:
        done = done | (this_step < config.tol)
    if config.tol_ratio > 0.0:
        done = done | (ratio < config.tol_ratio)

    updated = FISTAState(x=x_next, y=y_next, t=t_curr, tau=tau, k=state.k + 1,
                         prev_step=this_step, done=done)
    if grad_stop is None:
        return updated, metrics, x_next, torch.ones_like(state.done)
    # The grad-norm stop freezes the state entirely (no update counted).
    new_state = tree_where(grad_stop, state._replace(done=torch.ones_like(state.done)),
                           updated)
    return new_state, metrics, x_next, ~grad_stop


def fista_step(problem, config: FISTAConfig, state: FISTAState, metrics: Metrics):
    """One FISTA iteration. Returns ``(new_state, new_metrics, x_next,
    update_applied)``; ``update_applied`` is False where the grad-norm rule
    stopped the iteration before the proximal update."""
    return _fista_step(Run(problem), config, state, metrics)


class _Carry(NamedTuple):
    state: FISTAState
    metrics: Metrics


def _prepare(problem, config: FISTAConfig, x0, L, generator):
    if L is None:
        L = lipschitz_for(problem, generator, n_iter=config.lipschitz_iters,
                          tol=config.lipschitz_tol)
    x = problem.x0() if x0 is None else x0
    L = torch.as_tensor(L, dtype=x.dtype, device=x.device)
    return init_state(problem, config, x, config.t_init_factor / L), L


def _solve(run: Run, config: FISTAConfig, state0: FISTAState, L, history: bool) -> SolveResult:
    """The loop of :func:`fista` / :func:`fista_with_history` on a
    :class:`Run` (one problem or a stack)."""
    carry = _Carry(state0, Metrics.zero(state0.k))
    live = lambda c: (c.state.k < config.max_iter) & ~c.state.done
    hist = None
    if not history:
        step = lambda c: _Carry(*_fista_step(run, config, c.state, c.metrics)[:2])
        stops = config.tol > 0.0 or config.tol_ratio > 0.0
        carry = run_loop(step, carry, config.max_iter, live, stops=stops)
    else:
        x = state0.x
        lead = state0.k.shape
        xs = x.new_empty(lead + (config.max_iter,) + x.shape[len(lead):])
        objs = x.new_empty(lead + (config.max_iter,))
        steps, taus = torch.empty_like(objs), torch.empty_like(objs)
        valid = torch.empty(objs.shape, dtype=torch.bool, device=x.device)
        for k in range(config.max_iter):
            on = live(carry)
            new_state, metrics, _, applied = _fista_step(run, config, carry.state, carry.metrics)
            carry = tree_where(on, _Carry(new_state, metrics), carry)
            xs.select(len(lead), k).copy_(carry.state.x)
            objs[..., k] = run(objective, carry.state.x)
            steps[..., k] = carry.state.prev_step
            valid[..., k] = on & applied
            taus[..., k] = carry.state.tau
        hist = History(x=xs, obj=objs, step_norm=steps, valid=valid, tau=taus)
    return SolveResult(x=carry.state.x, n_iters=carry.state.k, L=L,
                       final_tau=carry.state.tau, metrics=carry.metrics, history=hist)


def fista(problem, config: FISTAConfig = FISTAConfig(), x0: torch.Tensor | None = None,
          L=None, generator: torch.Generator | None = None) -> SolveResult:
    """Solve to a stop rule or ``max_iter`` (no per-iteration outputs)."""
    state0, L = _prepare(problem, config, x0, L, generator)
    return _solve(Run(problem), config, state0, L, history=False)


def fista_with_history(problem, config: FISTAConfig = FISTAConfig(),
                       x0: torch.Tensor | None = None, L=None,
                       generator: torch.Generator | None = None) -> SolveResult:
    """``max_iter`` rows of iterates, objectives, step norms and steps (the
    reference's ``return_history=True``); rows past the stop repeat the
    final iterate with ``valid=False``."""
    state0, L = _prepare(problem, config, x0, L, generator)
    return _solve(Run(problem), config, state0, L, history=True)


def fista_delta_config(delta: float, **kw) -> FISTAConfig:
    """The Δ-momentum variant's configuration (reference ``fista_delta``)."""
    return FISTAConfig(momentum="delta", delta=delta, **kw)
