"""Hand-batched Gram-form FISTA in torch (port of
``fastoptsolver_tpu/batch/fista_gram.py``).

The torch driver: the CPU path, and the route the router takes for every
configuration the CUDA kernels refuse (Armijo where Q must stream, n past
1016). Same feature-major layout as the
reference — state ``(n, B)``, Gram ``(n, n, B)``, instances on the last axis —
and the same lockstep semantics: every ``check_every`` iterations a batched
relative duality gap marks certified instances, whose lanes freeze; the loop
ends when all are certified or ``max_iter`` is reached.

Differences from the JAX driver, all forced by the framework:

- ``lax.while_loop``/``fori_loop`` become Python loops; the
  "any lane still live" test syncs with the host once per ``check_every``
  block (the JAX version evaluates it on the device).
- ``jax.random`` streams cannot be reproduced in torch, so
  :func:`make_gram_batch` takes the power-iteration start ``v0`` or an explicit
  ``torch.Generator``, or a finished ``L``.
- The einsums run in the tensors' dtype. The package ``__init__`` turns TF32
  off, so an f32 contraction on a GPU is true f32 (the reference pins
  ``Precision.HIGHEST`` for the same reason).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.prox import soft_threshold
from ..utils.pytree import register_dataclass


@register_dataclass
@dataclasses.dataclass(frozen=True)
class GramBatch:
    """A batch of Gram-form instances in feature-major layout."""

    Q: torch.Tensor  # (n, n, B)
    c: torch.Tensor  # (n, B)
    btb: torch.Tensor  # (B,)
    alpha1: torch.Tensor  # (B,)
    alpha2: torch.Tensor  # (B,)
    L: torch.Tensor  # (B,) — λ_max(AᵀA) + α₂ per instance

    @property
    def batch(self) -> int:
        return self.Q.shape[-1]

    @property
    def dim(self) -> int:
        return self.Q.shape[0]


def _gram_matvec(Q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ijb,jb->ib", Q, v)


def _batched_power_L(Q: torch.Tensor, v0: torch.Tensor, n_iter: int,
                     tol: float) -> torch.Tensor:
    """Per-lane power iteration on (n, n, B) Gram tensors: λ_max(Q) per
    instance, all instances in lockstep. Stops after ``n_iter`` steps or once
    every lane's estimate moved by less than ``tol``."""
    def norm(v):
        return torch.sqrt(torch.sum(v * v, dim=0))

    v = v0 / torch.clamp_min(norm(v0), 1e-30)
    L = torch.zeros(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    prev = torch.full_like(L, float("inf"))
    k = 0
    while k < n_iter and bool(torch.any(torch.abs(L - prev) >= tol)):
        w = _gram_matvec(Q, v)
        prev = L
        L = norm(w)
        v = w / torch.clamp_min(L, 1e-30)
        k += 1
    return L


def _lane_vector(value, B: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (B,) value as a contiguous (B,) tensor of ``like``'s
    dtype and device; raises on any other shape."""
    v = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    if v.dim() > 1 or (v.dim() == 1 and v.shape[0] != B):
        raise ValueError(f"expected a scalar or a ({B},) vector, got shape "
                         f"{tuple(v.shape)}")
    return v.expand(B).contiguous()


def make_gram_batch(
    A: torch.Tensor,  # (B, m, n)
    b: torch.Tensor,  # (B, m)
    alpha1,
    alpha2,
    v0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    power_iters: int = 100,
    power_tol: float = 1e-6,
    dtype: torch.dtype | None = None,
    estimate_l: bool = True,
    L: torch.Tensor | None = None,
) -> GramBatch:
    """Batched Gram precompute + per-instance Lipschitz estimation.

    ``alpha1``/``alpha2`` may be scalars or (B,) tensors. The power
    iteration starts from ``v0`` (n, B) when given, else from a standard
    normal draw of ``generator`` (default: a fresh generator on ``A``'s
    device seeded with 0). ``L`` (B,) skips the estimate and is used as
    given (it must already include α₂). ``estimate_l=False`` fills ``L`` with
    the reference's 1.0 sentinel."""
    if dtype is not None:
        A = A.to(dtype)
        b = b.to(dtype)
    B, _, n = A.shape
    Q = torch.einsum("bmi,bmj->ijb", A, A)
    c = torch.einsum("bmi,bm->ib", A, b)
    btb = torch.einsum("bm,bm->b", b, b)
    a1 = _lane_vector(alpha1, B, A)
    a2 = _lane_vector(alpha2, B, A)
    if L is not None:
        L = _lane_vector(L, B, A)
    elif estimate_l:
        if v0 is None:
            if generator is None:
                generator = torch.Generator(device=A.device).manual_seed(0)
            v0 = torch.randn((n, B), generator=generator, dtype=A.dtype,
                             device=A.device)
        L = _batched_power_L(Q, v0.to(A.dtype), power_iters, power_tol) + a2
    else:
        L = torch.ones((B,), dtype=A.dtype, device=A.device)
    return GramBatch(Q=Q, c=c, btb=btb, alpha1=a1, alpha2=a2, L=L)


@dataclasses.dataclass(frozen=True)
class BatchFISTAConfig:
    max_iter: int = 500
    check_every: int = 10  # duality-gap check cadence (0 = never, run max_iter)
    rel_gap_tol: float = 1e-6
    t_init_factor: float = 1.0
    momentum: str = "nesterov"  # "nesterov" | "delta" | "greedy"
    delta: float = 3.0
    adaptive_restart: bool = False
    restart_threshold: float = 1.0
    # Armijo backtracking, reference semantics (sufficient decrease with
    # C=1e-2, shrink η=0.5, per-lane τ persists and never grows).
    backtracking: bool = False
    ls_eta: float = 0.5
    armijo_c: float = 1e-2
    max_backtracks: int = 20
    # "greedy" mode (Liang & Schönlieb 2018): overshoot the step to ξ/L with
    # unit momentum, restart on the gradient-mapping angle test, and shrink τ
    # back toward 1/L when steps grow.
    greedy_xi: float = 1.3
    greedy_S: float = 1.02
    greedy_shrink: float = 0.96

    def __post_init__(self):
        if self.momentum == "delta" and not self.delta > 2:
            raise ValueError("FISTA-Δ requires delta > 2")
        if self.momentum not in ("nesterov", "delta", "greedy"):
            raise ValueError(f"Unknown momentum '{self.momentum}'")
        if self.momentum == "greedy" and not 1.0 <= self.greedy_xi < 2.0:
            raise ValueError("greedy FISTA requires 1 <= greedy_xi < 2")
        if self.backtracking and self.momentum == "greedy":
            raise ValueError(
                "backtracking and greedy momentum both control τ; pick one"
            )


class BatchState(NamedTuple):
    X: torch.Tensor  # (n, B)
    Y: torch.Tensor  # (n, B)
    t: torch.Tensor  # (B,)
    prev_step: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32 — iteration count at convergence
    gap: torch.Tensor  # (B,) last measured relative gap
    k: int  # lockstep iterations run
    tau: torch.Tensor  # (B,) per-lane step (greedy/Armijo shrink it; 0 = fill from L)
    first_step: torch.Tensor  # (B,) ‖x_1 − x_0‖, the greedy safeguard reference


class BatchResult(NamedTuple):
    x: torch.Tensor  # (B, n)
    iters: torch.Tensor  # (B,)
    rel_gap: torch.Tensor  # (B,)
    n_iters_total: int | torch.Tensor  # lockstep iterations actually run
    converged: torch.Tensor  # (B,) bool
    failed: torch.Tensor | None = None  # (B,) bool: non-finite iterate/gap


def _rel_gap(gb: GramBatch, X: torch.Tensor) -> torch.Tensor:
    """Batched relative duality gap (ops/gap.py of the reference has the
    derivation), feature-major. One extra Gram matvec per check."""
    QX = _gram_matvec(gb.Q, X)
    xQx = torch.sum(X * QX, dim=0)
    cx = torch.sum(gb.c * X, dim=0)
    xx = torch.sum(X * X, dim=0)
    l1 = torch.sum(torch.abs(X), dim=0)
    rr = torch.clamp_min(xQx - 2.0 * cx + gb.btb, 0.0)
    rb = cx - gb.btb
    u = QX - gb.c + gb.alpha2 * X
    u_inf = torch.amax(torch.abs(u), dim=0)
    uu = torch.sum(u * u, dim=0)

    f = 0.5 * rr + 0.5 * gb.alpha2 * xx + gb.alpha1 * l1
    s = torch.where(u_inf > gb.alpha1,
                    gb.alpha1 / torch.clamp_min(u_inf, 1e-30),
                    torch.ones_like(u_inf))
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * gb.alpha2 * (s * s) * xx
    l1_gap = torch.clamp_min(f + dual_neg, 0.0)
    smooth_gap = uu / torch.where(gb.alpha2 > 0, 2.0 * gb.alpha2,
                                  torch.ones_like(gb.alpha2))
    gap = torch.where(gb.alpha1 > 0, l1_gap, smooth_gap)
    return gap / torch.clamp_min(f, 1.0)


def _smooth_value(gb: GramBatch, Z: torch.Tensor, QZ: torch.Tensor):
    """g(z) = ½zᵀQz − cᵀz + ½bᵀb + ½α₂‖z‖² per lane (the Armijo test's
    smooth part, ½bᵀb included as in the reference)."""
    return (0.5 * torch.sum(Z * QZ, dim=0) - torch.sum(gb.c * Z, dim=0)
            + 0.5 * gb.btb + 0.5 * gb.alpha2 * torch.sum(Z * Z, dim=0))


def _armijo_step(gb: GramBatch, cfg: BatchFISTAConfig, s: BatchState,
                 QY: torch.Tensor, grad: torch.Tensor):
    """Masked per-lane Armijo search: accept when g(x⁺) ≤ g(y) + C⟨∇g(y),
    x⁺−y⟩, shrink τ ← η·τ otherwise; a lane's accepted τ persists and never
    grows. All lanes in lockstep, one Gram matvec per trial round."""
    g_y = _smooth_value(gb, s.Y, QY)

    def trial(tau):
        Xc = soft_threshold(s.Y - tau * grad, tau * gb.alpha1)
        g_x = _smooth_value(gb, Xc, _gram_matvec(gb.Q, Xc))
        ok = g_x <= g_y + cfg.armijo_c * torch.sum(grad * (Xc - s.Y), dim=0)
        return Xc, ok

    tau = s.tau
    X, acc = trial(tau)
    k = 0
    while bool(torch.any(~acc)) and k < cfg.max_backtracks:
        tau = torch.where(acc, tau, cfg.ls_eta * tau)
        Xc, ok = trial(tau)
        X = torch.where(acc[None, :], X, Xc)
        acc = acc | ok
        k += 1
    return tau, X


def _iterate_block(gb: GramBatch, cfg: BatchFISTAConfig, state: BatchState,
                   n_steps: int) -> BatchState:
    """Run ``n_steps`` lockstep FISTA iterations; converged lanes frozen."""
    tau_min = (1.0 / gb.L).to(gb.c.dtype)  # greedy shrink floor
    s = state
    for _ in range(n_steps):
        QY = _gram_matvec(gb.Q, s.Y)
        grad = QY - gb.c + gb.alpha2 * s.Y
        if cfg.backtracking:
            tau_bt, X_next = _armijo_step(gb, cfg, s, QY, grad)
        else:
            tau_bt = s.tau
            X_next = soft_threshold(s.Y - s.tau * grad, s.tau * gb.alpha1)
        this_step = torch.sqrt(torch.sum((X_next - s.X) ** 2, dim=0))
        tau_next = tau_bt
        first_step = s.first_step

        if cfg.momentum == "delta":
            k_ref = float(s.k + 1)
            theta = k_ref / (k_ref + 1.0 + cfg.delta)
            Y_next = X_next + theta * (X_next - s.X)
            t_next = s.t
        elif cfg.momentum == "greedy":
            # unit momentum with a gradient-mapping restart
            Y_next = X_next + (X_next - s.X)
            restart = torch.sum((s.Y - X_next) * (X_next - s.X), dim=0) >= 0.0
            Y_next = torch.where(restart[None, :], X_next, Y_next)
            t_next = s.t
            # safeguard: shrink τ toward 1/L on step growth and on restarts
            first_step = torch.where(s.first_step == 0.0, this_step,
                                     s.first_step)
            grow = this_step > cfg.greedy_S * first_step
            tau_next = torch.where(
                grow | restart,
                torch.maximum(cfg.greedy_shrink * s.tau, tau_min),
                s.tau,
            )
        else:
            t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * s.t ** 2))
            beta = (s.t - 1.0) / t_next
            Y_next = X_next + beta * (X_next - s.X)
            if cfg.adaptive_restart:
                ratio = torch.where(
                    s.prev_step > 0.0,
                    this_step / torch.clamp_min(s.prev_step, 1e-30),
                    torch.full_like(this_step, float("inf")),
                )
                restart = ratio > cfg.restart_threshold
                t_next = torch.where(restart, torch.ones_like(t_next), t_next)
                Y_next = torch.where(restart[None, :], X_next, Y_next)

        live = ~s.done
        s = BatchState(
            X=torch.where(live[None, :], X_next, s.X),
            Y=torch.where(live[None, :], Y_next, s.Y),
            t=torch.where(live, t_next, s.t),
            prev_step=torch.where(live, this_step, s.prev_step),
            done=s.done,
            iters=s.iters + live.to(torch.int32),
            gap=s.gap,
            k=s.k + 1,
            tau=torch.where(live, tau_next, s.tau),
            first_step=torch.where(live, first_step, s.first_step),
        )
    return s


def init_batch_state(gb: GramBatch) -> BatchState:
    n, B = gb.c.shape
    z = lambda *shape: torch.zeros(shape, dtype=gb.c.dtype, device=gb.c.device)
    return BatchState(
        X=z(n, B),
        Y=z(n, B),
        t=torch.ones((B,), dtype=gb.c.dtype, device=gb.c.device),
        prev_step=z(B),
        done=torch.zeros((B,), dtype=torch.bool, device=gb.c.device),
        iters=torch.zeros((B,), dtype=torch.int32, device=gb.c.device),
        gap=torch.full((B,), float("inf"), dtype=gb.c.dtype,
                       device=gb.c.device),
        k=0,
        # tau=0 is a sentinel: fista_gram_batch fills it from (cfg, L), so
        # states built here resume correctly under any momentum mode.
        tau=z(B),
        first_step=z(B),
    )


def fista_gram_batch(
    gb: GramBatch,
    cfg: BatchFISTAConfig = BatchFISTAConfig(),
    state0: BatchState | None = None,
    return_state: bool = False,
):
    """Solve the whole batch; exits as soon as every instance is certified at
    ``rel_gap_tol`` (or at ``max_iter``).

    ``state0`` resumes a previous run exactly (``max_iter`` counts total
    iterations including the resumed ones). With ``return_state`` the final
    state is returned alongside the result."""
    xi = cfg.greedy_xi if cfg.momentum == "greedy" else cfg.t_init_factor
    tau0 = (xi / gb.L).to(gb.c.dtype)
    if state0 is None:
        state0 = init_batch_state(gb)
    state0 = state0._replace(k=int(state0.k),
                             tau=torch.where(state0.tau > 0.0, state0.tau, tau0))

    if cfg.check_every <= 0:
        remaining = max(cfg.max_iter - state0.k, 0)
        final = _iterate_block(gb, cfg, state0, remaining)
        gap = _rel_gap(gb, final.X)
        failed = ~torch.all(torch.isfinite(final.X), dim=0) | torch.isnan(gap)
        final = final._replace(gap=gap,
                               done=(gap <= cfg.rel_gap_tol) & ~failed)
        result = BatchResult(
            x=final.X.T,
            iters=final.iters,
            rel_gap=gap,
            n_iters_total=final.k,
            converged=final.done,
            failed=failed,
        )
        return (result, final) if return_state else result

    s = state0
    while s.k < cfg.max_iter and bool(torch.any(~s.done)):
        gap_before = s.gap
        s = _iterate_block(gb, cfg, s, cfg.check_every)
        gap = _rel_gap(gb, s.X)
        # quarantine: a lane whose iterate went non-finite is marked done
        # with gap=inf so the healthy lanes don't spin until max_iter
        failed = ~torch.all(torch.isfinite(s.X), dim=0) | torch.isnan(gap)
        newly_done = (~s.done) & ((gap <= cfg.rel_gap_tol) | failed)
        if cfg.momentum == "greedy":
            # outer safeguard: a live lane whose gap did not improve over a
            # whole check window gets its τ halved toward 1/L
            stuck = (~s.done) & (gap > 0.9 * gap_before)
            tau = torch.where(
                stuck,
                torch.maximum(0.5 * s.tau, (1.0 / gb.L).to(s.tau.dtype)),
                s.tau,
            )
            s = s._replace(tau=tau)
        inf = torch.full_like(gap, float("inf"))
        s = s._replace(
            done=s.done | newly_done,
            gap=torch.where(s.done, s.gap, torch.where(failed, inf, gap)),
        )

    failed = ~torch.all(torch.isfinite(s.X), dim=0)
    result = BatchResult(
        x=s.X.T,
        iters=s.iters,
        rel_gap=s.gap,
        n_iters_total=s.k,
        converged=(s.done | (s.gap <= cfg.rel_gap_tol)) & ~failed,
        failed=failed,
    )
    return (result, s) if return_state else result
