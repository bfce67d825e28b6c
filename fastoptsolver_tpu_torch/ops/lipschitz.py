"""Lipschitz-constant estimation via power iteration (port of
``fastoptsolver_tpu/ops/lipschitz.py``).

The reference's recurrence: ``w = AᵀAv; L = ||w||; v = w/L``, at most 100
iterations, stopping once ``|L − prev| < tol``, in an operator form (A) or a
Gram form (Q = AᵀA). Differences, forced by the framework:

- The start vector comes from an explicit ``torch.Generator`` (default: one
  seeded with 0 on the tensor's device), where the reference draws from
  ``jax.random.normal(PRNGKey(0))``; torch cannot reproduce that stream, so
  the two packages start from other vectors and agree on λ to the power
  iteration's tolerance, not bit for bit. :func:`_power_iteration` takes
  ``v0`` itself, and given the same ``v0`` the two agree to f32 rounding.
- ``lax.while_loop`` becomes a Python loop that reads the stop test on the
  host once every ``_STOP_EVERY`` steps: the masks freeze each stopped
  problem, so the steps past a stop change no bit and a host round trip a
  step buys nothing.
- :func:`estimate_lipschitz_gram` also takes a stack of Grams ``(..., n, n)``
  and gives each problem the one shared start vector and its own stop, as
  ``jax.vmap(estimate_lipschitz_gram)`` does: a problem's estimate freezes at
  the step where its own test ends its loop.
"""
from __future__ import annotations

import torch

_STOP_EVERY = 10  # steps between host reads of the stop test


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _power_iteration(matvec, v0: torch.Tensor, n_iter: int, tol: float) -> torch.Tensor:
    """λ of the largest-magnitude eigenvalue by power iteration from ``v0``
    (n,) or a batch (..., n); ``matvec`` maps (..., n) to (..., n). Each
    problem runs while ``k < n_iter`` and ``|L − prev| >= tol``, and keeps its
    L from the step its own test stopped it."""
    tiny = torch.finfo(v0.dtype).tiny
    v = v0 / torch.clamp_min(_norm(v0), tiny)[..., None]
    L = torch.zeros(v0.shape[:-1], dtype=v0.dtype, device=v0.device)
    prev = torch.full_like(L, float("inf"))
    live = torch.ones(L.shape, dtype=torch.bool, device=v0.device)
    for k in range(n_iter):
        live = live & (torch.abs(L - prev) >= tol)
        if k % _STOP_EVERY == 0 and not bool(live.any()):
            break
        w = matvec(v)
        Lw = _norm(w)
        v = torch.where(live[..., None], w / torch.clamp_min(Lw, tiny)[..., None], v)
        prev = torch.where(live, L, prev)
        L = torch.where(live, Lw, L)
    return L


def _start(n: int, like: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.randn((n,), generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def estimate_lipschitz(A: torch.Tensor, generator: torch.Generator | None = None,
                       n_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """λ_max(AᵀA) via power iteration on the two-matvec operator."""
    v0 = _start(A.shape[-1], A, generator)
    return _power_iteration(lambda v: A.T @ (A @ v), v0, n_iter, tol)


def estimate_lipschitz_gram(Q: torch.Tensor, generator: torch.Generator | None = None,
                            n_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """λ_max(Q) for symmetric PSD Q (= AᵀA), one matvec per iteration; Q may
    be a stack (..., n, n), one λ per problem (see the module note)."""
    v0 = _start(Q.shape[-1], Q, generator).expand(Q.shape[:-1])
    return _power_iteration(lambda v: (Q @ v[..., None])[..., 0], v0, n_iter, tol)


def lipschitz_for(problem, generator: torch.Generator | None = None,
                  n_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """Smooth-part Lipschitz constant for a least-squares problem:
    λ_max(AᵀA) + α₂ (the +α₂ whenever the ridge term is in the smooth
    part). A problem with ``normal_matvec`` supplies its own AᵀA operator
    (and, when its iterate is sharded, ``from_full`` for the start vector)."""
    if hasattr(problem, "normal_matvec"):
        v0 = _start(problem.dim, problem.A, generator)
        if hasattr(problem, "from_full"):  # a sharded iterate: this rank's part
            v0 = problem.from_full(v0)
        L = _power_iteration(problem.normal_matvec, v0, n_iter, tol)
    elif hasattr(problem, "Q"):
        L = estimate_lipschitz_gram(problem.Q, generator, n_iter, tol)
    else:
        L = estimate_lipschitz(problem.A, generator, n_iter, tol)
    if getattr(problem, "ridge_in_smooth", True):
        L = L + getattr(problem, "alpha2", 0.0)
    return L
