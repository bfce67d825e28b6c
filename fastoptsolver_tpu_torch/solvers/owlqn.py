"""OWL-QN: Orthant-Wise Limited-memory Quasi-Newton (Andrew & Gao, 2007;
port of ``fastoptsolver_tpu/solvers/owlqn.py``).

The quasi-Newton method that minimizes ``g(x) + α₁‖x‖₁`` itself, where the
reference's L-BFGS drops the L1 term:

- the **pseudo-gradient** ◇f replaces ∇f (the one-sided derivative that
  allows descent where x_i = 0);
- the two-loop direction (from *smooth*-gradient curvature pairs,
  ``solvers/lbfgs.py``) is **sign-aligned** against −◇f;
- every line-search trial is **projected onto the orthant** chosen at the
  start of the iteration, so iterates are exactly sparse;
- backtracking sufficient decrease on the full objective with the
  pseudo-gradient inner product. The backtracking loop reads its acceptance
  on the host after each trial; the outer loop reads its stop every
  iteration (the search reads the host anyway).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .common import (
    History,
    Metrics,
    SolveResult,
    dot,
    norm,
    run_loop,
    tree_where,
)
from .lbfgs import two_loop_direction


@dataclasses.dataclass(frozen=True)
class OWLQNConfig:
    memory: int = 10
    max_iter: int = 500
    tol: float = 1e-6  # stop when ||pseudo-grad||_inf <= tol
    c1: float = 1e-4  # sufficient-decrease constant
    ls_shrink: float = 0.5
    max_ls_steps: int = 40
    curvature_eps: float = 1e-10
    gamma_init: float = 1.0


def pseudo_gradient(x: torch.Tensor, g: torch.Tensor, alpha1) -> torch.Tensor:
    """◇f for f = g + α₁‖·‖₁ (Andrew & Gao eq. 4): at x_i ≠ 0 the L1 term is
    differentiable; at x_i = 0 take the one-sided derivative if it permits
    descent, else 0."""
    right = g + alpha1  # derivative moving positive
    left = g - alpha1  # derivative moving negative
    zero = torch.zeros_like(g)
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(x > 0, right, torch.where(x < 0, left, at_zero))


def _project_orthant(v: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """π(v; ξ): zero coordinates whose sign disagrees with the orthant ξ."""
    return torch.where(torch.sign(v) == xi, v, torch.zeros_like(v))


class OWLQNState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor  # FULL composite objective
    g: torch.Tensor  # smooth gradient (curvature pairs use this, per the paper)
    v: torch.Tensor  # pseudo-gradient
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    count: torch.Tensor
    head: torch.Tensor
    gamma: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor


class _Carry(NamedTuple):
    state: OWLQNState
    metrics: Metrics


def _init(problem, config: OWLQNConfig, x0) -> OWLQNState:
    x = problem.x0() if x0 is None else x0
    g = problem.smooth_grad(x)
    v = pseudo_gradient(x, g, problem.alpha1)
    mem, n = config.memory, x.shape[0]
    zi = torch.zeros((), dtype=torch.int32, device=x.device)
    return OWLQNState(
        x=x, f=problem.objective(x), g=g, v=v, S=x.new_zeros((mem, n)),
        Y=x.new_zeros((mem, n)), rho=x.new_zeros((mem,)), count=zi, head=zi,
        gamma=torch.full((), config.gamma_init, dtype=x.dtype, device=x.device), k=zi,
        done=torch.amax(torch.abs(v)) <= config.tol)


def _direction(state: OWLQNState):
    """The aligned direction, the orthant ξ and the first trial step."""
    v = state.v
    d = two_loop_direction(v, state.S, state.Y, state.rho, state.count, state.head,
                           state.gamma)
    # alignment (paper §3.2): drop components whose sign disagrees with −v;
    # fall back to −v if that empties the direction
    d = torch.where(d * (-v) > 0, d, torch.zeros_like(d))
    d = torch.where(torch.any(d != 0), d, -v)
    # orthant of this iteration: sign(x_i), or sign(−v_i) where x_i = 0
    xi = torch.where(state.x != 0, torch.sign(state.x), torch.sign(-v))
    # first iteration: the unit step scaled by 1/‖v‖ (the paper's start)
    a0 = torch.where(state.count == 0, 1.0 / torch.clamp_min(norm(v), 1.0),
                     torch.ones_like(state.f))
    return d, xi, a0


def _trial(problem, state: OWLQNState, d, xi, a, c1: float):
    x_new = _project_orthant(state.x + a * d, xi)
    f_new = problem.objective(x_new)
    # sufficient decrease wrt the pseudo-gradient (paper eq. 5)
    ok = f_new <= state.f + c1 * dot(state.v, x_new - state.x)
    return x_new, f_new, ok


def _update(problem, state: OWLQNState, x_new, f_new, accepted, config: OWLQNConfig):
    # on total line-search failure keep the current point (and stop below)
    x_new = torch.where(accepted, x_new, state.x)
    f_new = torch.where(accepted, f_new, state.f)
    g_new = problem.smooth_grad(x_new)
    v_new = pseudo_gradient(x_new, g_new, problem.alpha1)
    # curvature pair from SMOOTH gradients (paper §3.2 point 1)
    s_vec = x_new - state.x
    y_vec = g_new - state.g
    sy = dot(s_vec, y_vec)
    keep = accepted & (sy > config.curvature_eps * norm(s_vec) * norm(y_vec))
    mem = config.memory
    slot = torch.arange(mem, device=x_new.device) == state.head
    S = torch.where(keep & slot[:, None], s_vec, state.S)
    Y = torch.where(keep & slot[:, None], y_vec, state.Y)
    rho = torch.where(keep & slot, 1.0 / torch.where(keep, sy, torch.ones_like(sy)), state.rho)
    head = torch.where(keep, torch.remainder(state.head + 1, mem), state.head)
    count = torch.where(keep, torch.clamp_max(state.count + 1, mem), state.count)
    gamma = torch.where(keep, sy / torch.clamp_min(dot(y_vec, y_vec), 1e-38), state.gamma)
    # stop on the pseudo-gradient tolerance, a line-search failure, or a step
    # that rounded back to x (no progress is possible at this precision)
    stalled = torch.all(x_new == state.x)
    done = (torch.amax(torch.abs(v_new)) <= config.tol) | ~accepted | stalled
    return OWLQNState(x=x_new, f=f_new, g=g_new, v=v_new, S=S, Y=Y, rho=rho, count=count,
                      head=head, gamma=gamma, k=state.k + 1, done=done)


def owlqn_step(problem, config: OWLQNConfig, state: OWLQNState, metrics: Metrics):
    """One OWL-QN iteration: ``(new_state, new_metrics)``."""
    d, xi, a = _direction(state)
    x_new, f_new, ok = _trial(problem, state, d, xi, a, config.c1)
    steps = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    for _ in range(config.max_ls_steps):
        on = ~ok
        if not bool(on.any()):
            break
        a = torch.where(on, a * config.ls_shrink, a)
        x_try, f_try, ok_try = _trial(problem, state, d, xi, a, config.c1)
        x_new = tree_where(on, x_try, x_new)
        f_new = torch.where(on, f_try, f_new)
        ok = torch.where(on, ok_try, ok)
        steps = steps + on.to(torch.int32)
    new_state = _update(problem, state, x_new, f_new, ok, config)
    metrics = metrics._replace(n_grad_evals=metrics.n_grad_evals + 1,
                               n_ls_calls=metrics.n_ls_calls + 1,
                               ls_iters_total=metrics.ls_iters_total + steps + 1)
    return new_state, metrics


def _start(problem, config: OWLQNConfig, x0) -> _Carry:
    state = _init(problem, config, x0)
    one = torch.ones((), dtype=torch.int32, device=state.x.device)
    return _Carry(state, Metrics(one, one * 0, one * 0))


def _result(carry: _Carry, hist=None) -> SolveResult:
    zero = torch.zeros_like(carry.state.f)
    return SolveResult(x=carry.state.x, n_iters=carry.state.k, L=zero, final_tau=zero,
                       metrics=carry.metrics, history=hist)


def owlqn(problem, config: OWLQNConfig = OWLQNConfig(), x0: torch.Tensor | None = None) -> SolveResult:
    """Minimize ``problem.smooth_value(x) + problem.alpha1·‖x‖₁``; the problem
    must expose ``alpha1``; ridge terms stay in the smooth part."""
    step = lambda c: _Carry(*owlqn_step(problem, config, c.state, c.metrics))
    live = lambda c: (c.state.k < config.max_iter) & ~c.state.done
    return _result(run_loop(step, _start(problem, config, x0), config.max_iter, live, every=1))


def owlqn_with_history(problem, config: OWLQNConfig = OWLQNConfig(),
                       x0: torch.Tensor | None = None) -> SolveResult:
    """``max_iter`` rows recording the composite objective an iteration;
    once stopped, the rows left repeat the final iterate with
    ``valid=False``, as the reference's padded scan gives."""
    carry = _start(problem, config, x0)
    x = carry.state.x
    xs = x.new_empty((config.max_iter, x.shape[-1]))
    objs = x.new_empty((config.max_iter,))
    steps = torch.zeros_like(objs)
    valid = torch.zeros(objs.shape, dtype=torch.bool, device=x.device)
    for k in range(config.max_iter):
        if bool(carry.state.done):
            xs[k:] = carry.state.x
            objs[k:] = carry.state.f
            break
        new = _Carry(*owlqn_step(problem, config, carry.state, carry.metrics))
        xs[k], objs[k] = new.state.x, new.state.f
        steps[k] = norm(new.state.x - carry.state.x)
        valid[k] = True
        carry = new
    return _result(carry, History(x=xs, obj=objs, step_norm=steps, valid=valid))
