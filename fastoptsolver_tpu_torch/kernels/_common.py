"""Plain PyTorch building blocks of the fused kernel (port of
``fastoptsolver_tpu/kernels/_common.py``).

They work on ``(rows, lanes)`` tensors — feature rows first, instances on the
last axis, per-lane scalars as ``(1, B)`` rows — and together form the plain
twin of the CUDA kernel ``csrc/fused_solve.cu`` (see
``fused_solve.fused_solve_reference``). The TPU helpers ``masked_cols``,
``accumulate_pairs``, ``acc_entry``, ``write_q_planes`` and ``assemble_c``
collapse into :func:`augmented_gram`: ragged-brick masking and sublane
padding were artefacts of Pallas block shapes.

Only the fixed-momentum (table-β) branch of ``certified_solve_body`` is
ported; adaptive restart, greedy and Armijo in the fused engine are still to
port (ROADMAP Queue 1 item 4). :func:`fista_general_chunk` and
:func:`fista_armijo_chunk` carry those modes for the burst engine
(``fista_vmem``, CUDA ``csrc/fista_burst.cu``).
"""
from __future__ import annotations

import torch


def augmented_gram(A: torch.Tensor, b: torch.Tensor):
    """``[A|b]ᵀ[A|b]`` per lane from ``A (n, m, B)`` and ``b (m, B)``:
    returns ``Q (n, n, B)``, ``c = Aᵀb (n, B)`` and ``bᵀb (1, B)``."""
    n = A.shape[0]
    Ab = torch.cat([A, b[None]], dim=0)
    G = torch.einsum("imb,jmb->ijb", Ab, Ab)
    return G[:n, :n], G[:n, n], G[n, n][None, :]


def make_matvec(Q: torch.Tensor, n: int):
    """Gram matvec against the per-lane ``Q (n, n, B)``, summed plane by
    plane over the true feature count as the kernel does."""
    def matvec(v):
        out = torch.zeros_like(v)
        for k in range(n):
            out = out + Q[k] * v[k:k + 1, :]
        return out

    return matvec


def _col_norm(v):
    return torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))


def power_lambda_max(matvec, c_vec: torch.Tensor, pl_iters: int):
    """``pl_iters`` power steps started from c (deterministic, generically
    non-orthogonal to the dominant eigenvector). Returns the per-lane (1, B)
    estimate of λ_max."""
    v = c_vec / torch.clamp_min(_col_norm(c_vec), 1e-30)
    L = torch.zeros_like(c_vec[0:1, :])
    for _ in range(pl_iters):
        w = matvec(v)
        L = _col_norm(w)
        v = w / torch.clamp_min(L, 1e-30)
    return L


def gram_rel_gap(X, matvec, c_vec, a1, a2, btb):
    """Per-lane relative duality gap in the kernel layout. Mirrors
    ``batch/fista_gram._rel_gap`` exactly — keep the two in sync."""
    return gram_rel_gap_from_qx(X, matvec(X), c_vec, a1, a2, btb)


def gram_rel_gap_from_qx(X, QX, c_vec, a1, a2, btb):
    """:func:`gram_rel_gap` with the Gram matvec ``QX`` precomputed."""
    red = lambda v: torch.sum(v, dim=0, keepdim=True)
    xQx = red(X * QX)
    cx = red(c_vec * X)
    xx = red(X * X)
    l1 = red(torch.abs(X))
    u = QX - c_vec + a2 * X
    u_inf = torch.amax(torch.abs(u), dim=0, keepdim=True)
    uu = red(u * u)
    rr = torch.clamp_min(xQx - 2.0 * cx + btb, 0.0)
    rb = cx - btb
    f = 0.5 * rr + 0.5 * a2 * xx + a1 * l1
    s = torch.where(u_inf > a1, a1 / torch.clamp_min(u_inf, 1e-30),
                    torch.ones_like(u_inf))
    dual_neg = 0.5 * (s * s) * rr + s * rb + 0.5 * a2 * (s * s) * xx
    l1_gap = torch.clamp_min(f + dual_neg, 0.0)
    smooth_gap = uu / torch.where(a2 > 0, 2.0 * a2, torch.ones_like(a2))
    gap = torch.where(a1 > 0, l1_gap, smooth_gap)
    return gap / torch.clamp_min(f, 1.0)


def _soft(V, thr):
    return torch.sign(V) * torch.clamp_min(torch.abs(V) - thr, 0.0)


def _red(v):
    return torch.sum(v, dim=0, keepdim=True)


def fista_fixed_chunk(matvec, betas: torch.Tensor, c_vec, tau, thr, a2,
                      chunk: int):
    """``chunk`` fixed-momentum FISTA iterations, β read from the table at
    ABSOLUTE iteration indices: ``(k0, X, Y) -> (X, Y)``. ``betas`` is a
    host (CPU) tensor so reading one entry never syncs with a device."""
    def run(k0, X, Y):
        for i in range(chunk):
            grad = matvec(Y) + a2 * Y - c_vec
            Xn = _soft(Y - tau * grad, thr)
            beta = float(betas[k0 + i])
            X, Y = Xn, Xn + beta * (Xn - X)
        return X, Y

    return run


def _restart_momentum(X, Xn, t, ps, restart_threshold):
    """Nesterov with adaptive restart (reference iterative_solvers.py:209-217):
    per-lane ``t`` and previous step norm ``ps``; returns ``(Yn, t, ps)``."""
    this = torch.sqrt(_red((Xn - X) ** 2))
    t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
    beta = (t - 1.0) / t_next
    Yn = Xn + beta * (Xn - X)
    ratio = torch.where(ps > 0.0, this / torch.clamp_min(ps, 1e-30),
                        torch.full_like(this, float("inf")))
    restart = ratio > restart_threshold
    t_next = torch.where(restart, torch.ones_like(t_next), t_next)
    Yn = torch.where(restart, Xn, Yn)
    return Yn, t_next, this


def fista_general_chunk(matvec, betas, c_vec, tau, thr, a1, a2, chunk: int,
                        restart_threshold, greedy, taumin):
    """``chunk`` FISTA iterations in any momentum mode but Armijo, carrying
    the per-lane rows: ``(k0, X, Y, t, ps) -> (X, Y, t, ps)``.

    - fixed (``restart_threshold`` and ``greedy`` None): β from the host
      table at absolute indices; ``t``/``ps`` pass through;
    - adaptive restart: per-lane Nesterov scalar ``t`` and previous step
      norm ``ps``;
    - greedy (``(S, shrink)``): ``t`` is the per-lane τ, ``ps`` the
      first-step norm; unit momentum, gradient-mapping restart, τ shrunk
      toward the floor ``taumin``.

    The same per-lane arithmetic as the reference's ``fista_general_chunk``."""
    def run(k0, X, Y, t, ps):
        for i in range(chunk):
            grad = matvec(Y) + a2 * Y - c_vec
            if greedy is not None:
                S_val, shrink = greedy
                Xn = _soft(Y - t * grad, t * a1)
                this = torch.sqrt(_red((Xn - X) ** 2))
                Yn = Xn + (Xn - X)  # unit momentum
                restart = _red((Y - Xn) * (Xn - X)) >= 0.0
                Yn = torch.where(restart, Xn, Yn)
                ps = torch.where(ps == 0.0, this, ps)
                grow = this > S_val * ps
                t = torch.where(grow | restart,
                                torch.maximum(shrink * t, taumin), t)
                X, Y = Xn, Yn
                continue
            Xn = _soft(Y - tau * grad, thr)
            if restart_threshold is None:
                beta = float(betas[k0 + i])
                X, Y = Xn, Xn + beta * (Xn - X)
                continue
            Y, t, ps = _restart_momentum(X, Xn, t, ps, restart_threshold)
            X = Xn
        return X, Y, t, ps

    return run


def fista_armijo_chunk(matvec, betas, c_vec, a1, a2, btb, chunk: int,
                       restart_threshold, armijo):
    """``chunk`` FISTA iterations with the masked per-lane Armijo search
    (reference iterative_solvers.py:183-197 semantics, C = ``armijo[0]``,
    shrink η = ``armijo[1]``, at most ``armijo[2]`` trial rounds):
    ``(k0, X, Y, t, ps, tau) -> (X, Y, t, ps, tau)``, ``tau`` the per-lane
    step row, which persists and never grows.

    Trial rounds run in lockstep over all lanes while any lane is still
    unaccepted; an accepted lane is left untouched. So a lane's outcome
    depends only on its own data, and a kernel may give each lane its own
    trial loop. The accept mask is a bool tensor (the reference carried it
    as float 0/1 only to get past Mosaic). Momentum is table-β when
    ``restart_threshold`` is None, else Nesterov with adaptive restart."""
    C, eta, max_bt = armijo

    def smooth(Z, QZ):
        return (0.5 * _red(Z * QZ) - _red(c_vec * Z) + 0.5 * btb
                + 0.5 * a2 * _red(Z * Z))

    def run(k0, X, Y, t, ps, tau):
        for i in range(chunk):
            QY = matvec(Y)
            grad = QY + a2 * Y - c_vec
            g_y = smooth(Y, QY)

            def trial(tv):
                Xc = _soft(Y - tv * grad, tv * a1)
                ok = smooth(Xc, matvec(Xc)) <= g_y + C * _red(grad * (Xc - Y))
                return Xc, ok

            Xn, acc = trial(tau)
            kbt = 0
            while bool(torch.any(~acc)) and kbt < max_bt:
                tau = torch.where(acc, tau, eta * tau)
                Xt, ok = trial(tau)
                Xn = torch.where(acc, Xn, Xt)
                acc = acc | ok
                kbt += 1
            if restart_threshold is None:
                beta = float(betas[k0 + i])
                X, Y = Xn, Xn + beta * (Xn - X)
                continue
            Y, t, ps = _restart_momentum(X, Xn, t, ps, restart_threshold)
            X = Xn
        return X, Y, t, ps, tau

    return run


def certified_solve_body(matvec, betas, c_vec, tau, thr, a1, a2, btb, *,
                         b_tile: int, chunk: int, k_end: int, tol: float):
    """The whole certified fixed-momentum solve, every lane tile at once.

    Each ``b_tile``-lane tile behaves as one CTA of the kernel (one Pallas
    grid column of the reference): bursts of ``chunk`` steps, then the gap,
    the non-finite quarantine and the done/iters/gap updates; the tile stops
    once all its lanes are done or ``k`` reaches ``k_end``. Certified lanes
    keep iterating until their tile stops. All tiles share ``k`` while they
    run, so a stopped tile is simply frozen. Returns ``(X, iters, gap,
    done)`` with per-lane rows ``(1, B)``; ``B`` must be a multiple of
    ``b_tile``."""
    B = c_vec.shape[1]
    nt = B // b_tile
    steps = fista_fixed_chunk(matvec, betas, c_vec, tau, thr, a2, chunk)
    X = torch.zeros_like(c_vec)
    Y = torch.zeros_like(c_vec)
    done = torch.zeros_like(tau, dtype=torch.bool)
    iters = torch.zeros_like(tau, dtype=torch.int32)
    gap = torch.full_like(tau, float("inf"))
    inf = torch.full_like(tau, float("inf"))
    k = 0
    while k < k_end:
        tile_live = ~done.view(nt, b_tile).all(dim=1)
        if not bool(tile_live.any()):
            break
        live = tile_live.repeat_interleave(b_tile)[None, :]
        Xn, Yn = steps(k, X, Y)
        k += chunk
        X = torch.where(live, Xn, X)
        Y = torch.where(live, Yn, Y)
        finite = torch.all(torch.isfinite(X), dim=0, keepdim=True)
        gp = torch.where(finite, gram_rel_gap(X, matvec, c_vec, a1, a2, btb),
                         inf)
        open_ = live & ~done
        iters = torch.where(open_, torch.full_like(iters, k), iters)
        gap = torch.where(open_, gp, gap)
        done = done | (open_ & ((gp <= tol) | ~finite))
    return X, iters, gap, done
