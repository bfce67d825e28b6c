"""Certified FISTA on the dense Gram form of ONE large instance (port of
``fastoptsolver_tpu/solvers/gram_dense.py``).

Companion to :mod:`..problems.streaming`: once an arbitrarily tall A has
been reduced to ``Q = AᵀA (n, n), c = Aᵀb, bᵀb`` in one streaming pass, the
solve never touches A again. Each iteration is one (n, n) matvec and the
shrinkage; every ``check_every`` iterations the relative duality gap is
evaluated and the host reads the stop, as the port's other solvers read
theirs. The recurrence is the reference's fixed-step FISTA with Nesterov
momentum and optional adaptive restart.

Differences from the reference, forced by the framework:

- ``lax.while_loop`` becomes a host loop over chunks of ``check_every``
  eager steps (about 20 launches a step); the power iteration reads its stop
  every 10 steps and freezes a stopped estimate, so its bits do not depend
  on the cadence (``ops/lipschitz.py``).
- The power iteration starts from a normal draw of a ``torch.Generator``
  (default: one seeded with 0 on Q's device), where the reference draws
  from ``jax.random``; :func:`_solve` takes the start vector itself.
- The gap is evaluated in float64, where the reference uses double-f32
  arithmetic (``ops/df32.py``, not ported): the card has native float64.
  Q, c and bᵀb are up-cast once a solve, which for a float32 Q costs a
  float64 copy of it (800 MB at n = 10000) beside the solve's Q. The two
  branches are the reference's: the general one while the dual scaling
  s < 1, and at s = 1 the form ``xᵀu + α₁‖x‖₁`` with every term O(f), which
  never cancels against bᵀb. The gap is returned in the iterate's dtype and
  compared with ``rel_gap_tol`` after that cast, as in the reference.

The floor that remains is the float32 rounding of the stored (Q, c, bᵀb)
itself; ``stream_gram``'s compensated accumulation keeps that to about one
rounding.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.lipschitz import _power_iteration
from ..ops.prox import soft_threshold
from ..problems.streaming import DenseGram


@dataclasses.dataclass(frozen=True)
class DenseGramConfig:
    max_iter: int = 2000
    check_every: int = 50
    rel_gap_tol: float = 1e-6
    t_init_factor: float = 1.0
    adaptive_restart: bool = False
    restart_threshold: float = 1.0
    power_iters: int = 100
    power_tol: float = 1e-6
    l_safety: float = 1.0


class DenseResult(NamedTuple):
    x: torch.Tensor  # (n,)
    iters: torch.Tensor  # () int32, iterations run
    rel_gap: torch.Tensor  # ()
    converged: torch.Tensor  # () bool
    L: torch.Tensor  # () Lipschitz estimate used


def _power_L(Q: torch.Tensor, v0: torch.Tensor, n_iter: int, tol: float) -> torch.Tensor:
    """λ_max(Q) by power iteration from ``v0`` (the reference's recurrence:
    at most ``n_iter`` steps, stopping once ``|L − prev| < tol``)."""
    return _power_iteration(lambda v: Q @ v, v0, n_iter, tol)


def _rel_gap_dense(Q, c, btb, alpha1, alpha2, X) -> torch.Tensor:
    """Scalar-instance relative duality gap, evaluated in float64 (inputs
    of another dtype are up-cast here; :func:`_solve` passes them up-cast
    once) and returned in ``X``'s dtype. Two regimes, as the reference:

    - while ``u_inf > α₁`` (s < 1) the general form, where the gap is large;
    - at s = 1, ``xᵀu + α₁‖x‖₁`` (u = Qx − c + α₂x), which equals the
      general form algebraically but has no O(bᵀb) cancellation."""
    f64 = torch.float64
    Q, c, btb = Q.to(f64), c.to(f64), btb.to(f64)
    x = X.to(f64)
    a1 = torch.as_tensor(alpha1, dtype=f64, device=x.device)
    a2 = torch.as_tensor(alpha2, dtype=f64, device=x.device)
    QX = Q @ x
    xQx = x @ QX
    cx = c @ x
    xx = x @ x
    l1 = torch.sum(torch.abs(x))
    rr = torch.clamp_min(xQx - 2.0 * cx + btb, 0.0)
    rb = cx - btb
    u = QX - c + a2 * x
    u_inf = torch.max(torch.abs(u))
    uu = u @ u
    xu = x @ u
    f = 0.5 * rr + 0.5 * a2 * xx + a1 * l1
    s = a1 / torch.clamp_min(u_inf, 1e-30)
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * a2 * (s * s) * xx
    gap_general = torch.clamp_min(f + dual_neg, 0.0)
    gap_s1 = torch.clamp_min(xu + a1 * l1, 0.0)
    l1_gap = torch.where(u_inf > a1, gap_general, gap_s1)
    smooth_gap = uu / torch.where(a2 > 0, 2.0 * a2, torch.ones_like(a2))
    gap = torch.where(a1 > 0, l1_gap, smooth_gap)
    return (gap / torch.clamp_min(f, 1.0)).to(X.dtype)


def fista_gram_dense(
    gram: DenseGram,
    alpha1,
    alpha2=0.0,
    config: DenseGramConfig = DenseGramConfig(),
    generator: torch.Generator | None = None,
) -> DenseResult:
    """Certified lasso/elastic-net solve of one Gram-form instance, on the
    device that holds ``gram``. The power iteration starts from a normal
    draw of ``generator`` (default: seeded with 0 on that device)."""
    Q = gram.Q
    if generator is None:
        generator = torch.Generator(device=Q.device).manual_seed(0)
    v0 = torch.randn((Q.shape[0],), generator=generator, dtype=Q.dtype,
                     device=generator.device).to(Q.device)
    return _solve(gram, alpha1, alpha2, v0, config)


def _solve(gram: DenseGram, alpha1, alpha2, v0: torch.Tensor,
           cfg: DenseGramConfig) -> DenseResult:
    """The certified solve from the power iteration's start ``v0``."""
    Q, c, btb = gram.Q, gram.c, gram.btb
    dtype, dev = Q.dtype, Q.device
    n = Q.shape[0]
    alpha1 = torch.as_tensor(alpha1, dtype=dtype, device=dev)
    alpha2 = torch.as_tensor(alpha2, dtype=dtype, device=dev)
    L = cfg.l_safety * _power_L(Q, v0, cfg.power_iters, cfg.power_tol) + alpha2
    L = torch.where(L > 0.0, L, torch.ones_like(L))
    tau = cfg.t_init_factor / L
    thr = tau * alpha1
    f64 = torch.float64
    Q64, c64, btb64 = Q.to(f64), c.to(f64), btb.to(f64)  # once a solve

    x = torch.zeros((n,), dtype=dtype, device=dev)
    y = torch.zeros_like(x)
    t = torch.ones((), dtype=dtype, device=dev)
    prev_step = torch.zeros((), dtype=dtype, device=dev)
    gap = torch.full((), float("inf"), dtype=dtype, device=dev)
    inf = gap.clone()
    chunk = cfg.check_every if cfg.check_every > 0 else cfg.max_iter
    k, done = 0, False
    while k < cfg.max_iter and not done:
        for _ in range(chunk):
            grad = Q @ y + alpha2 * y - c
            x_next = soft_threshold(y - tau * grad, thr)
            this_step = torch.linalg.vector_norm(x_next - x)
            t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t ** 2))
            beta = (t - 1.0) / t_next
            y = x_next + beta * (x_next - x)
            if cfg.adaptive_restart:
                ratio = torch.where(prev_step > 0.0,
                                    this_step / torch.clamp_min(prev_step, 1e-30), inf)
                restart = ratio > cfg.restart_threshold
                t_next = torch.where(restart, torch.ones_like(t_next), t_next)
                y = torch.where(restart, x_next, y)
            x, t, prev_step = x_next, t_next, this_step
        k += chunk
        gap = _rel_gap_dense(Q64, c64, btb64, alpha1, alpha2, x)
        bad = ~torch.all(torch.isfinite(x)) | torch.isnan(gap)
        gap = torch.where(bad, inf, gap)
        done = bool((gap <= cfg.rel_gap_tol) | bad)  # the host's read a chunk
    ok = torch.all(torch.isfinite(x)) & (gap <= cfg.rel_gap_tol)
    return DenseResult(x=x, iters=torch.tensor(k, dtype=torch.int32, device=dev),
                       rel_gap=gap, converged=ok, L=L)
