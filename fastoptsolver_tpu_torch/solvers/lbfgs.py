"""L-BFGS from scratch (port of ``fastoptsolver_tpu/solvers/lbfgs.py``).

- **Two-loop recursion** over a fixed-size ring buffer of curvature pairs
  ``(s, y)`` in stacked ``(memory, n)`` tensors; unfilled slots are masked.
  The ring is read newest-first through one gather, so the recursion has no
  data-dependent index inside its loops.
- **Strong-Wolfe line search** (c1 = 1e-4, c2 = 0.9) as the reference's
  bounded bracket-then-zoom state machine, one value-and-grad evaluation a
  trial. Each ``lax.cond`` of the reference is a ``torch.where`` here, so a
  trial is one pure tensor function (:func:`_wolfe_trial`) that
  ``batch.solve_batch`` vmaps; the loop over trials reads its stop on the
  host after every trial (one or two, usually, of ``max_ls_steps``).
- **Stopping** as SciPy's: ``pgtol`` on the gradient ∞-norm and the
  ``factr``-style relative decrease; the outer loop reads its flag every
  iteration (the line search reads the host anyway), a stopped problem of
  a stack frozen meanwhile.
- **Cautious updates**: a pair is skipped unless ``sᵀy`` is sufficiently
  positive.

Minimizes ``problem.smooth_value`` only, as the reference does (its lasso
quirk: the ``α₁‖x‖₁`` term is left out of the optimized function, while
:func:`lbfgs_with_history` records the full ``problem.objective``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .common import (
    History,
    Metrics,
    Run,
    SolveResult,
    dot,
    norm,
    objective,
    run_loop,
    tree_where,
)

_F64_EPS = float(torch.finfo(torch.float64).eps)


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    memory: int = 10
    max_iter: int = 500
    tol: float = 1e-6  # pgtol: stop when ||g||_inf <= tol (scipy fmin_l_bfgs_b pgtol)
    ftol: float = 1e7 * _F64_EPS  # scipy factr=1e7 default
    c1: float = 1e-4
    c2: float = 0.9
    max_ls_steps: int = 30
    step_max: float = 1e8
    gamma_init: float = 1.0
    curvature_eps: float = 1e-10


# ---------------------------------------------------------------------------
# Two-loop recursion over the ring buffer
# ---------------------------------------------------------------------------


def two_loop_direction(g, S, Y, rho, count, head, gamma):
    """Search direction ``d = -H_k g`` by the two-loop recursion.

    ``S``/``Y`` are (memory, n) ring buffers, ``head`` the next write slot,
    ``count`` the number of valid pairs; slot ``(head-1) % memory`` holds the
    newest pair. The ring is gathered newest-first once, so slot ``i`` of the
    gathered copy is the i-th newest pair, valid for ``i < count``."""
    mem = S.shape[0]
    order = torch.remainder(head - 1 - torch.arange(mem, device=g.device), mem)
    S_o, Y_o, rho_o = S[order], Y[order], rho[order]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    q, alphas = g, []
    for i in range(mem):  # newest to oldest
        a = torch.where(i < count, rho_o[i] * dot(S_o[i], q), zero)
        q = q - a * Y_o[i]
        alphas.append(a)
    r = gamma * q
    for i in reversed(range(mem)):  # oldest valid to newest
        b = rho_o[i] * dot(Y_o[i], r)
        r = r + torch.where(i < count, S_o[i] * (alphas[i] - b), zero)
    return -r


# ---------------------------------------------------------------------------
# Strong-Wolfe line search (bracket + zoom), one evaluation a trial
# ---------------------------------------------------------------------------

_BRACKETING, _ZOOM, _ACCEPTED, _FAILED = 0, 1, 2, 3


class _LSState(NamedTuple):
    mode: torch.Tensor
    a: torch.Tensor  # current trial step
    a_prev: torch.Tensor
    phi_prev: torch.Tensor
    dphi_prev: torch.Tensor
    a_lo: torch.Tensor
    phi_lo: torch.Tensor
    dphi_lo: torch.Tensor
    g_lo: torch.Tensor
    a_hi: torch.Tensor
    phi_hi: torch.Tensor
    i: torch.Tensor
    a_star: torch.Tensor
    phi_star: torch.Tensor
    g_star: torch.Tensor
    n_evals: torch.Tensor


def _pick(pred, on_true: _LSState, on_false: _LSState) -> _LSState:
    return tree_where(pred, on_true, on_false)


def _wolfe_trial(problem, x, f0, d, dphi0, s: _LSState, cfg: LBFGSConfig) -> _LSState:
    """One trip of the reference's line-search ``while_loop`` body: evaluate
    at ``s.a`` and move the state machine, every branch as a select."""
    a = s.a
    phi, g = problem.smooth_value_and_grad(x + a * d)
    dphi = dot(g, d)
    n_evals = s.n_evals + 1
    armijo_ok = phi <= f0 + cfg.c1 * a * dphi0
    curv_ok = torch.abs(dphi) <= -cfg.c2 * dphi0
    mode = lambda v: torch.full_like(s.mode, v)

    # -- bracketing --
    hit_hi = (~armijo_ok) | ((s.i > 0) & (phi >= s.phi_prev))
    # bracket is (a_prev, a): lo = prev point, hi = current
    to_zoom_hi = s._replace(mode=mode(_ZOOM), a_lo=s.a_prev, phi_lo=s.phi_prev,
                            dphi_lo=s.dphi_prev, a_hi=a, phi_hi=phi,
                            a=0.5 * (s.a_prev + a))
    accept = s._replace(mode=mode(_ACCEPTED), a_star=a, phi_star=phi, g_star=g)
    # derivative turned positive: bracket is (a, a_prev)
    to_zoom_lo = s._replace(mode=mode(_ZOOM), a_lo=a, phi_lo=phi, dphi_lo=dphi, g_lo=g,
                            a_hi=s.a_prev, phi_hi=s.phi_prev, a=0.5 * (a + s.a_prev))
    expand = s._replace(a_prev=a, phi_prev=phi, dphi_prev=dphi,
                        a=torch.clamp_max(2.0 * a, cfg.step_max))
    out = _pick(hit_hi, to_zoom_hi, _pick(curv_ok, accept, _pick(dphi >= 0, to_zoom_lo, expand)))
    # the latest sufficient-decrease point is the fallback
    fb = armijo_ok & (phi < out.phi_star)
    took = out.mode == _ACCEPTED
    bracket = out._replace(
        i=out.i + 1, n_evals=n_evals,
        a_star=torch.where(took, out.a_star, torch.where(fb, a, out.a_star)),
        phi_star=torch.where(took, out.phi_star, torch.where(fb, phi, out.phi_star)),
        g_star=tree_where(took, out.g_star, tree_where(fb, g, out.g_star)))

    # -- zoom --
    hit_hi = (~armijo_ok) | (phi >= s.phi_lo)
    shrink_hi = s._replace(a_hi=a, phi_hi=phi)
    flip = dphi * (s.a_hi - s.a_lo) >= 0
    update = s._replace(a_hi=torch.where(flip, s.a_lo, s.a_hi),
                        phi_hi=torch.where(flip, s.phi_lo, s.phi_hi),
                        a_lo=a, phi_lo=phi, dphi_lo=dphi, g_lo=g)
    out = _pick(hit_hi, shrink_hi, _pick(curv_ok, accept, update))
    interval = torch.abs(out.a_hi - out.a_lo)
    degenerate = (out.mode == _ZOOM) & (interval < 1e-14 * torch.clamp_min(out.a_hi, 1.0))
    zoom = out._replace(
        i=out.i + 1, n_evals=n_evals,
        a=torch.where(out.mode == _ACCEPTED, out.a, 0.5 * (out.a_lo + out.a_hi)),
        # degenerate interval: give up on Wolfe, keep the lo point
        mode=torch.where(degenerate, mode(_FAILED), out.mode))

    return _pick(s.mode == _BRACKETING, bracket, zoom)


def _wolfe_init(f0, g0, d) -> tuple[_LSState, torch.Tensor]:
    dphi0 = dot(g0, d)
    zero = torch.zeros_like(f0)
    return _LSState(
        mode=torch.full(f0.shape, _BRACKETING, dtype=torch.int32, device=f0.device),
        a=torch.ones_like(f0), a_prev=zero, phi_prev=f0, dphi_prev=dphi0,
        a_lo=zero, phi_lo=f0, dphi_lo=dphi0, g_lo=g0, a_hi=zero, phi_hi=f0,
        i=torch.zeros(f0.shape, dtype=torch.int32, device=f0.device),
        a_star=zero, phi_star=f0, g_star=g0,
        n_evals=torch.zeros(f0.shape, dtype=torch.int32, device=f0.device)), dphi0


def _wolfe_result(s: _LSState):
    accepted = s.mode == _ACCEPTED
    # zoom's a_lo meets sufficient decrease once set; prefer it over the
    # bracketing fallback when no Wolfe point was reached
    use_lo = (~accepted) & (s.a_lo > 0.0) & (s.phi_lo <= s.phi_star)
    a = torch.where(accepted, s.a_star, torch.where(use_lo, s.a_lo, s.a_star))
    f = torch.where(accepted, s.phi_star, torch.where(use_lo, s.phi_lo, s.phi_star))
    g = tree_where(accepted, s.g_star, tree_where(use_lo, s.g_lo, s.g_star))
    ok = accepted | (a > 0.0)
    return a, f, g, s.n_evals, ok


def _wolfe_search(run: Run, x, f0, g0, d, cfg: LBFGSConfig):
    s, dphi0 = _wolfe_init(f0, g0, d)
    for _ in range(cfg.max_ls_steps):
        on = (s.mode < _ACCEPTED) & (s.i < cfg.max_ls_steps)
        if not bool(on.any()):
            break
        s = tree_where(on, run(_wolfe_trial, x, f0, d, dphi0, s, cfg), s)
    return _wolfe_result(s)


def wolfe_line_search(problem, x, f0, g0, d, cfg: LBFGSConfig):
    """Find ``a`` meeting the strong Wolfe conditions along ``d``. Returns
    ``(a, f(x+ad), ∇f(x+ad), n_evals, ok)``; without a Wolfe point within the
    budget it falls back to the best sufficient-decrease point seen, and
    ``ok`` is False only if not even sufficient decrease was found."""
    return _wolfe_search(Run(problem), x, f0, g0, d, cfg)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


class LBFGSState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    S: torch.Tensor  # (memory, n)
    Y: torch.Tensor  # (memory, n)
    rho: torch.Tensor  # (memory,)
    count: torch.Tensor
    head: torch.Tensor
    gamma: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor
    ls_failed: torch.Tensor


class _Carry(NamedTuple):
    state: LBFGSState
    metrics: Metrics


def _init_piece(problem, x, cfg: LBFGSConfig) -> LBFGSState:
    f, g = problem.smooth_value_and_grad(x)
    mem, n = cfg.memory, x.shape[0]
    zi = torch.zeros((), dtype=torch.int32, device=x.device)
    return LBFGSState(
        x=x, f=f, g=g, S=x.new_zeros((mem, n)), Y=x.new_zeros((mem, n)),
        rho=x.new_zeros((mem,)), count=zi, head=zi,
        gamma=torch.full((), cfg.gamma_init, dtype=x.dtype, device=x.device), k=zi,
        done=torch.amax(torch.abs(g)) <= cfg.tol,
        ls_failed=torch.zeros((), dtype=torch.bool, device=x.device))


def _direction_piece(problem, s: LBFGSState):
    d = two_loop_direction(s.g, s.S, s.Y, s.rho, s.count, s.head, s.gamma)
    # safeguard: steepest descent on a non-descent direction
    return torch.where(dot(s.g, d) < 0, d, -s.g)


def _update_piece(problem, s: LBFGSState, d, a, f_new, g_new, ok, cfg: LBFGSConfig):
    x_new = s.x + a * d
    s_vec = x_new - s.x
    y_vec = g_new - s.g
    sy = dot(s_vec, y_vec)
    keep = sy > cfg.curvature_eps * norm(s_vec) * norm(y_vec)
    mem = cfg.memory
    slot = torch.arange(mem, device=x_new.device) == s.head
    S = torch.where(keep & slot[:, None], s_vec, s.S)
    Y = torch.where(keep & slot[:, None], y_vec, s.Y)
    rho = torch.where(keep & slot, 1.0 / torch.where(keep, sy, torch.ones_like(sy)), s.rho)
    head = torch.where(keep, torch.remainder(s.head + 1, mem), s.head)
    count = torch.where(keep, torch.clamp_max(s.count + 1, mem), s.count)
    gamma = torch.where(keep, sy / torch.clamp_min(dot(y_vec, y_vec), 1e-38), s.gamma)
    # stop: pgtol on the gradient ∞-norm; factr-style relative decrease;
    # line-search failure
    pg_small = torch.amax(torch.abs(g_new)) <= cfg.tol
    f_flat = (s.f - f_new) <= cfg.ftol * torch.clamp_min(
        torch.maximum(torch.abs(s.f), torch.abs(f_new)), 1.0)
    done = pg_small | f_flat | ~ok
    return LBFGSState(x=x_new, f=f_new, g=g_new, S=S, Y=Y, rho=rho, count=count,
                      head=head, gamma=gamma, k=s.k + 1, done=done, ls_failed=~ok)


def _lbfgs_step(run: Run, cfg: LBFGSConfig, state: LBFGSState, metrics: Metrics):
    d = run(_direction_piece, state)
    a, f_new, g_new, n_evals, ok = _wolfe_search(run, state.x, state.f, state.g, d, cfg)
    metrics = metrics._replace(n_grad_evals=metrics.n_grad_evals + n_evals,
                               n_ls_calls=metrics.n_ls_calls + 1,
                               ls_iters_total=metrics.ls_iters_total + n_evals)
    return run(_update_piece, state, d, a, f_new, g_new, ok, cfg), metrics


def lbfgs_step(problem, config: LBFGSConfig, state: LBFGSState, metrics: Metrics):
    """One L-BFGS iteration: ``(new_state, new_metrics)``."""
    return _lbfgs_step(Run(problem), config, state, metrics)


def _init(run: Run, config: LBFGSConfig, x0) -> _Carry:
    x = run(lambda p: p.x0()) if x0 is None else x0
    state = run(_init_piece, x, config)
    ones = torch.ones(state.k.shape, dtype=torch.int32, device=x.device)
    return _Carry(state, Metrics(ones, ones * 0, ones * 0))


def _result(carry: _Carry, hist=None) -> SolveResult:
    zero = torch.zeros_like(carry.state.f)
    return SolveResult(x=carry.state.x, n_iters=carry.state.k, L=zero, final_tau=zero,
                       metrics=carry.metrics, history=hist)


def _solve(run: Run, config: LBFGSConfig, x0, history: bool) -> SolveResult:
    """The loop of :func:`lbfgs` / :func:`lbfgs_with_history` on a
    :class:`Run` (one problem or a stack)."""
    carry = _init(run, config, x0)
    step = lambda c: _Carry(*_lbfgs_step(run, config, c.state, c.metrics))
    live = lambda c: (c.state.k < config.max_iter) & ~c.state.done
    if not history:
        # each step reads the host in its line search already, so the stop is
        # read every step: a stopped problem runs no line searches for nothing
        return _result(run_loop(step, carry, config.max_iter, live, every=1))
    x = carry.state.x
    lead = x.shape[:-1]
    xs = x.new_empty(lead + (config.max_iter, x.shape[-1]))
    objs = x.new_empty(lead + (config.max_iter,))
    steps = torch.empty_like(objs)
    valid = torch.empty(objs.shape, dtype=torch.bool, device=x.device)
    for k in range(config.max_iter):
        on = live(carry)
        if not bool(on.any()):  # the rest of the rows repeat the final state
            xs[..., k:, :] = carry.state.x[..., None, :]
            objs[..., k:] = run(objective, carry.state.x)[..., None]
            steps[..., k:] = 0.0
            valid[..., k:] = False
            break
        new = tree_where(on, step(carry), carry)
        xs[..., k, :] = new.state.x
        objs[..., k] = run(objective, new.state.x)
        steps[..., k] = norm(new.state.x - carry.state.x)
        valid[..., k] = on
        carry = new
    return _result(carry, History(x=xs, obj=objs, step_norm=steps, valid=valid))


def lbfgs(problem, config: LBFGSConfig = LBFGSConfig(), x0: torch.Tensor | None = None) -> SolveResult:
    """Minimize ``problem.smooth_value`` (see the module note on lasso)."""
    return _solve(Run(problem), config, x0, history=False)


def lbfgs_with_history(problem, config: LBFGSConfig = LBFGSConfig(),
                       x0: torch.Tensor | None = None) -> SolveResult:
    """``max_iter`` rows recording the *full* composite objective an
    iteration, as the reference's callback history does (with its lasso
    quirk: the optimized function leaves out the L1 term, the history has
    it). Once every problem has stopped, the rows left repeat the final
    iterate with ``valid=False``, as the reference's padded scan gives."""
    return _solve(Run(problem), config, x0, history=True)
