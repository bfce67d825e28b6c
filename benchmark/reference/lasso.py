"""The plain reference for batched lasso: ``min_x ½‖Ax − b‖² + α₁‖x‖₁`` per
lane, in plain PyTorch, written from the problem's definition.

It imports nothing of the program and takes nothing the program made: it is
handed the benchmark's own ``A (n, m, B)``, ``b (m, B)`` and ``α₁ (B,)``
(feature-leading, as the benchmark makes them) and works out the Gram, the
Lipschitz constant and the optimum itself.

- :func:`rel_gap` — every lane's relative duality gap at a given x, in
  float64, from the residual ``r = b − Ax`` (no Gram, so no cancellation in
  ``xᵀQx − 2cᵀx + bᵀb``): the gap of the dual point ``θ = s·r`` with
  ``s = min(1, α₁/‖Aᵀr‖∞)``, over ``max(f(x), 1)`` as the program defines its
  certificate.
- :func:`solve` — FISTA with gradient restart on the lane Grams, every lane
  frozen once its own gap is at ``tol``; in float64 it is the optimum.
- :func:`optimum` — :func:`solve` in float64 on chosen lanes, to 1e-12.
- :func:`control` — the same solver put in the program's place one precision
  below the configuration's float32: the Gram formed from TF32-rounded
  inputs (10 mantissa bits, as the tensor cores round them; products exact,
  sums in float32), the rest in float32, stopped at the configuration's own
  tolerance. The benchmark's comparison has to call its answers wrong.

Every float32 product here runs with TF32 off, whatever the process set.
"""
from __future__ import annotations

import contextlib

import torch

F64 = torch.float64


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for matmuls and einsums in the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def lane_blocks(n: int, m: int, B: int, budget_bytes: int = 1 << 28):
    """``(start, stop)`` lane ranges whose float64 copy of A fits the budget."""
    step = max(1, budget_bytes // (8 * n * m))
    return [(s, min(B, s + step)) for s in range(0, B, step)]


def rel_gap(A, b, alpha1, x):
    """``(rel_gap (B,), f (B,))`` in float64 at ``x (B, n)``; a lane whose x
    is not finite reads ``inf``."""
    n, m, B = A.shape
    gaps = torch.empty(B, dtype=F64, device=A.device)
    objs = torch.empty(B, dtype=F64, device=A.device)
    for s, e in lane_blocks(n, m, B):
        Ab = A[:, :, s:e].to(F64)
        bb = b[:, s:e].to(F64)
        xb = x[s:e].to(device=A.device, dtype=F64).T  # (n, Bb)
        a = alpha1[s:e].to(F64)
        r = bb - (Ab * xb[:, None, :]).sum(0)
        u = -(Ab * r[None]).sum(1)  # Aᵀ(Ax − b)
        rr = (r * r).sum(0)
        f = 0.5 * rr + a * xb.abs().sum(0)
        u_inf = u.abs().amax(0)
        scale = torch.where(u_inf > a, a / u_inf.clamp_min(1e-300), torch.ones_like(a))
        dual = scale * (bb * r).sum(0) - 0.5 * scale * scale * rr
        g = (f - dual).clamp_min(0.0) / f.clamp_min(1.0)
        gaps[s:e] = torch.nan_to_num(g, nan=float("inf"))
        objs[s:e] = f
    return gaps, objs


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest, ties away from zero, as the tensor cores convert their inputs."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gram(A, b, rounding=None):
    """``Q (B, n, n)``, ``c (B, n)``, ``bᵀb (B,)`` in A's dtype with TF32
    off; ``rounding`` is applied to A and b first."""
    if rounding is not None:
        A, b = rounding(A), rounding(b)
    with _exact_f32():
        Q = torch.einsum("imb,jmb->bij", A, A)
        c = torch.einsum("imb,mb->bi", A, b)
        btb = torch.einsum("mb,mb->b", b, b)
    return Q, c, btb


def _matvec(Q, v):
    return torch.bmm(Q, v[:, :, None])[:, :, 0]


def lipschitz(Q, steps: int = 300, safety: float = 1.1):
    """``safety``·λ_max(Q) per lane, λ_max by ``steps`` power steps from a
    fixed random start."""
    gen = torch.Generator(device=Q.device).manual_seed(0)
    v = torch.randn(Q.shape[:2], generator=gen, dtype=Q.dtype, device=Q.device)
    v = v / v.norm(dim=1, keepdim=True)
    lam = torch.ones(Q.shape[0], dtype=Q.dtype, device=Q.device)
    for _ in range(steps):
        w = _matvec(Q, v)
        lam = w.norm(dim=1)
        v = w / lam.clamp_min(torch.finfo(Q.dtype).tiny)[:, None]
    return safety * torch.where(lam > 0, lam, torch.ones_like(lam))


def gram_rel_gap(Q, c, btb, alpha1, x):
    """The relative gap from the Gram, in Q's dtype: what a solver that
    holds only the Gram can certify itself with."""
    Qx = _matvec(Q, x)
    xQx, cx = (x * Qx).sum(1), (c * x).sum(1)
    rr = (xQx - 2.0 * cx + btb).clamp_min(0.0)
    f = 0.5 * rr + alpha1 * x.abs().sum(1)
    u_inf = (Qx - c).abs().amax(1)
    s = torch.where(u_inf > alpha1, alpha1 / u_inf.clamp_min(1e-30), torch.ones_like(u_inf))
    dual_neg = 0.5 * s * s * rr + s * (cx - btb)
    return (f + dual_neg).clamp_min(0.0) / f.clamp_min(1.0)


def solve(Q, c, btb, alpha1, *, tol: float, max_iter: int, check_every: int):
    """FISTA with gradient restart, step 1/L, each lane frozen at the first
    check where its own Gram gap is ≤ ``tol``. Returns
    ``(x (B, n), converged (B,), rel_gap (B,), iters (B,))`` in Q's dtype."""
    B, n = c.shape
    alpha1 = alpha1.to(Q.dtype)
    step = 1.0 / lipschitz(Q)
    thr = (step * alpha1)[:, None]
    x = torch.zeros_like(c)
    y = torch.zeros_like(c)
    t = torch.ones(B, dtype=Q.dtype, device=Q.device)
    done = torch.zeros(B, dtype=torch.bool, device=Q.device)
    gap = torch.full((B,), float("inf"), dtype=Q.dtype, device=Q.device)
    iters = torch.zeros(B, dtype=torch.int64, device=Q.device)
    for k in range(1, max_iter + 1):
        z = y - step[:, None] * (_matvec(Q, y) - c)
        x_new = torch.sign(z) * (z.abs() - thr).clamp_min(0.0)
        restart = ((y - x_new) * (x_new - x)).sum(1) > 0
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y_new = x_new + ((t - 1.0) / t_new)[:, None] * (x_new - x)
        y_new = torch.where(restart[:, None], x_new, y_new)
        t_new = torch.where(restart, torch.ones_like(t_new), t_new)
        live = ~done[:, None]
        x, y = torch.where(live, x_new, x), torch.where(live, y_new, y)
        t = torch.where(done, t, t_new)
        if k % check_every == 0 or k == max_iter:
            g = torch.nan_to_num(gram_rel_gap(Q, c, btb, alpha1, x), nan=float("inf"))
            gap = torch.where(done, gap, g)
            iters = torch.where(done, iters, torch.full_like(iters, k))
            done = done | (g <= tol)
            if bool(done.all()):
                break
    return x, done, gap, iters


def optimum(A, b, alpha1, lanes, tol: float = 1e-12, max_iter: int = 20000):
    """The float64 optimum of the chosen lanes: ``(x* (S, n), f* (S,),
    gap (S,))``, the gap from :func:`rel_gap`."""
    Q, c, btb = gram(A[:, :, lanes].to(F64), b[:, lanes].to(F64))
    x, _, _, _ = solve(Q, c, btb, alpha1[lanes].to(F64), tol=tol, max_iter=max_iter,
                       check_every=25)
    gap, f = rel_gap(A[:, :, lanes], b[:, lanes], alpha1[lanes], x)
    return x, f, gap


def control(A, b, alpha1, *, tol: float, max_iter: int, check_every: int):
    """The reference one precision below float32, in the program's place:
    ``(x (B, n), converged (B,), rel_gap (B,), iters (B,))`` for every lane,
    in lane blocks of a bounded size."""
    n, m, B = A.shape
    parts = []
    for s, e in lane_blocks(n, m, B, budget_bytes=1 << 29):
        Q, c, btb = gram(A[:, :, s:e], b[:, s:e], rounding=tf32)
        parts.append(solve(Q, c, btb, alpha1[s:e].float(), tol=tol, max_iter=max_iter,
                           check_every=check_every))
    return tuple(torch.cat(p) for p in zip(*parts))
