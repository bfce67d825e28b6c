"""Shared solver infrastructure (port of ``fastoptsolver_tpu/solvers/common.py``):
metrics carried in the solver state, results, the Armijo search, and the
host loop that replaces ``lax.while_loop``.

The reference's solvers are ``lax.while_loop``/``lax.scan`` fixed points
whose conditions live on the device. Here a solve is a Python loop of eager
torch ops, and a stop flag read on the host costs a device round trip, so:

- **Frozen steps.** Every step is applied through :func:`tree_where` on the
  live flag, as ``jax.vmap`` of a ``while_loop`` does: a stopped state stays
  bit for bit what it was. The loop therefore reads its flag only once every
  :data:`STOP_EVERY` steps (:func:`run_loop`); the steps past a stop change
  nothing. With no stop rule configured (``tol = 0``, the default) the loop
  runs exactly ``max_iter`` steps and reads nothing.
- **One problem or a stack.** A solver's pieces are pure tensor functions of
  ``(problem, ...)`` with ``torch.where`` for every ``lax.cond``, called
  through a :class:`Run`: as they are on one problem, or under
  ``torch.func.vmap`` over a stacked problem (``batch.solve_batch``). The
  loops, and the inner line-search loops with their own stop read each
  trial, stay outside, so one driver serves both.

The Armijo search keeps the reference's contract: sufficient decrease
``g(x⁺) ≤ g(y) + C·⟨∇g(y), x⁺−y⟩`` with C = 1e-2, shrink η, at most
``max_backtracks`` trials after the first, the accepted τ persisting.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# Armijo sufficient-decrease constant, the reference's module-level ``C``.
ARMIJO_C = 1e-2

# Steps between host reads of a loop's stop flag: the frozen steps past a
# stop change no bit, so a read a step would buy nothing but a round trip.
STOP_EVERY = 10


class Metrics(NamedTuple):
    """Per-solve counters (0-d int32 tensors; a batch carries one per problem)."""

    n_grad_evals: torch.Tensor
    n_ls_calls: torch.Tensor
    ls_iters_total: torch.Tensor

    @classmethod
    def zero(cls, like: torch.Tensor | None = None) -> "Metrics":
        """Zero counters, 0-d, or shaped and placed like ``like`` ((B,) over
        a stack)."""
        z = (torch.zeros((), dtype=torch.int32) if like is None else
             torch.zeros(like.shape, dtype=torch.int32, device=like.device))
        return cls(n_grad_evals=z, n_ls_calls=z, ls_iters_total=z)


class History(NamedTuple):
    """Fixed-length per-iteration trace, ``max_iter`` rows preallocated;
    rows with ``valid == False`` repeat the last real iterate."""

    x: torch.Tensor  # (max_iter, n)
    obj: torch.Tensor  # (max_iter,)
    step_norm: torch.Tensor  # (max_iter,)
    valid: torch.Tensor  # (max_iter,) bool
    tau: torch.Tensor | None = None  # (max_iter,) step size used at each iteration


class SolveResult(NamedTuple):
    x: torch.Tensor
    n_iters: torch.Tensor
    L: torch.Tensor  # Lipschitz estimate used (0 where not applicable)
    final_tau: torch.Tensor  # last accepted step size
    metrics: Metrics
    history: History | None = None


def tree_where(pred: torch.Tensor, on_true, on_false):
    """Elementwise ``where`` over matching (named) tuples of tensors. ``pred``
    is 0-d, or (B,) over a stack whose leaves lead with B: it is padded on the
    right to each leaf's rank."""
    if isinstance(on_true, tuple):
        parts = [tree_where(pred, a, b) for a, b in zip(on_true, on_false)]
        return type(on_true)(*parts) if hasattr(on_true, "_fields") else tuple(parts)
    p = pred.reshape(pred.shape + (1,) * (on_true.dim() - pred.dim()))
    return torch.where(p, on_true, on_false)


class Run:
    """Calls a solver's pure pieces ``fn(problem, *args)`` on one problem, or,
    with ``batched=True``, under ``torch.func.vmap`` over the leading axis of
    a stacked problem's tensors and of every argument."""

    def __init__(self, problem, batched: bool = False):
        self.problem = problem
        self.batched = batched
        if batched:
            self._tensors = {f.name: getattr(problem, f.name)
                             for f in dataclasses.fields(problem)
                             if isinstance(getattr(problem, f.name), torch.Tensor)}

    def __call__(self, fn, *args):
        if not self.batched:
            return fn(self.problem, *args)
        problem = self.problem

        def one(tensors, *a):
            return fn(dataclasses.replace(problem, **tensors), *a)

        # tensors (and tuples of them) are split along their leading axis;
        # Python numbers, flags and configs pass through whole
        dims = (0,) + tuple(0 if isinstance(a, (torch.Tensor, tuple)) else None
                            for a in args)
        return torch.func.vmap(one, in_dims=dims)(self._tensors, *args)


def run_loop(step, carry, max_iter: int, live, stops: bool = True,
             every: int = STOP_EVERY):
    """``carry = step(carry)`` up to ``max_iter`` times, each step frozen
    where ``live(carry)`` is False; the flag is read on the host every
    ``every`` steps and the loop ends once no problem is live. With
    ``stops=False`` (no stop rule configured) every step runs."""
    for k in range(max_iter):
        if not stops:
            carry = step(carry)
            continue
        on = live(carry)
        if k % every == 0 and not bool(on.any()):
            break
        carry = tree_where(on, step(carry), carry)
    return carry


def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    backtracking: bool = False
    eta: float = 0.5
    armijo_c: float = ARMIJO_C
    max_backtracks: int = 60


def _armijo_trial(problem, y, g_y, grad, t, armijo_c: float):
    x_new = problem.prox(y - t * grad, t)
    ok = problem.smooth_value(x_new) <= g_y + armijo_c * dot(grad, x_new - y)
    return x_new, ok


def armijo_prox_search(problem, y, g_y, grad, tau0, ls: LineSearchConfig,
                       run: Run | None = None):
    """Backtracking prox line search from trial step ``tau0``.

    Returns ``(x_new, tau_accepted, n_backtracks)`` where ``x_new =
    prox(y − τ·grad, τ)`` for the first τ in {tau0·ηᵏ} meeting the Armijo
    condition (or the last trial after ``max_backtracks``). One smooth value
    a trial; the acceptance is read on the host after each trial (usually
    one or two). ``run`` evaluates the trials over a stack."""
    run = Run(problem) if run is None else run
    x, ok = run(_armijo_trial, y, g_y, grad, tau0, ls.armijo_c)
    t = tau0
    steps = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    for _ in range(ls.max_backtracks):
        on = ~ok
        if not bool(on.any()):
            break
        t = torch.where(on, t * ls.eta, t)
        x_try, ok_try = run(_armijo_trial, y, g_y, grad, t, ls.armijo_c)
        x = tree_where(on, x_try, x)
        ok = torch.where(on, ok_try, ok)
        steps = steps + on.to(torch.int32)
    return x, t, steps


# Pure pieces shared by the prox-gradient solvers, for ``Run``.

def grad_part(problem, x, with_value: bool):
    """``(g(x), ∇g(x))``, or ``(0, ∇g(x))`` when the value is not needed."""
    if with_value:
        return problem.smooth_value_and_grad(x)
    return torch.zeros((), dtype=x.dtype, device=x.device), problem.smooth_grad(x)


def prox_step(problem, x, grad, tau):
    return problem.prox(x - tau * grad, tau)


def objective(problem, x):
    return problem.objective(x)
