"""Plain PyTorch building blocks of the fused kernel (port of
``fastoptsolver_tpu/kernels/_common.py``).

They work on ``(rows, lanes)`` tensors — feature rows first, instances on the
last axis, per-lane scalars as ``(1, B)`` rows — and together form the plain
twin of the CUDA kernel ``csrc/fused_solve.cu`` (see
``fused_solve.fused_solve_reference``). The TPU helpers ``masked_cols``,
``accumulate_pairs``, ``acc_entry``, ``write_q_planes`` and ``assemble_c``
collapse into :func:`augmented_gram`: ragged-brick masking and sublane
padding were artefacts of Pallas block shapes.

Every in-kernel momentum mode is here: :func:`fista_general_chunk` (fixed
table-β, adaptive restart, greedy) and :func:`fista_armijo_chunk` carry the
burst engine (``fista_vmem``, CUDA ``csrc/fista_burst.cu``) and the
Q-streaming engine (``qstream``, ``csrc/qstream.cu``);
:func:`certified_solve_body` runs the whole certified solve of the fused
twin (``fused_solve``, CUDA ``csrc/fused_solve.cu``) and of the resident
engine (``resident``, ``csrc/resident.cu``), in every mode, with resume.
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


def _beta_at(betas, k0, i: int):
    """β of step ``i`` of a chunk that starts at ``k0``: a float read from
    the host table when ``k0`` is an int, a per-lane row gathered from the
    table when ``k0`` is a ``(1, B)`` index row (a lane past the table's end,
    in a group that has stopped, reads its last entry)."""
    if isinstance(k0, int):
        return float(betas[k0 + i])
    return betas.to(k0.device)[torch.clamp(k0 + i, max=betas.numel() - 1)]


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

    - fixed (``restart_threshold`` and ``greedy`` None): β from the table
      at absolute indices (``k0`` an int, or a per-lane row: :func:`_beta_at`);
      ``t``/``ps`` pass through;
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
                beta = _beta_at(betas, k0, i)
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
                beta = _beta_at(betas, k0, i)
                X, Y = Xn, Xn + beta * (Xn - X)
                continue
            Y, t, ps = _restart_momentum(X, Xn, t, ps, restart_threshold)
            X = Xn
        return X, Y, t, ps, tau

    return run


def assert_tile_k_uniform(k, B: int, b_tile: int, offset: int = 0) -> None:
    """Resume guard of the per-lane-k engines (reference
    ``kernels/_common.py:173``): ``k`` must be uniform within every
    ``b_tile``-lane group starting at ``offset``. A checkpoint cut under
    another grouping would put lanes at different iterations into one
    lockstep group, which neither the kernel nor its twin represents."""
    kh = torch.as_tensor(k).detach().cpu().reshape(-1)
    for s0 in range(offset, offset + B, b_tile):
        seg = kh[s0:min(s0 + b_tile, offset + B)]
        if seg.numel() and bool((seg != seg[0]).any()):
            raise ValueError(
                f"state0.k is not uniform within lane tile [{s0}, "
                f"{s0 + b_tile}): the checkpoint was taken under a different "
                "tile grouping (b_tile); resume with the grouping that "
                "produced it"
            )


def certified_solve_body(matvec, betas, c_vec, tau, thr, a1, a2, btb,
                         taumin=None, state0=None, *, b_tile: int, chunk: int,
                         k_end: int, tol: float, restart_threshold=None,
                         greedy=None, armijo=None):
    """The whole certified solve, every ``b_tile``-lane group at once, in
    any momentum mode (reference ``kernels/_common.py:200``).

    Each group behaves as one CTA of the kernels (one Pallas grid step of
    the reference): bursts of ``chunk`` steps (:func:`fista_general_chunk`,
    or :func:`fista_armijo_chunk` when ``armijo``), then the gap, the
    non-finite quarantine, the greedy stuck-lane shrink and the
    done/iters/gap updates; a group stops once all its lanes are done or its
    ``k`` reaches ``k_end``. Certified lanes keep iterating until their
    group stops. Each group keeps its own ``k``, so a stopped group stays
    frozen while the others run, and a resumed state may hold groups at
    different iterations.

    ``state0`` is None or the 9-tuple ``(X, Y, t, ps, tv, k, done, iters,
    gap)`` of ``(n, B)`` planes and ``(1, B)`` rows (``k`` an integer row,
    uniform within each group); the same 9-tuple comes back. ``tv`` is the
    per-lane Armijo step, which only the Armijo search changes."""
    B = c_vec.shape[1]
    dev = c_vec.device
    betas = betas.cpu()  # an int k0 reads it without a device sync
    if state0 is None:
        X, Y = torch.zeros_like(c_vec), torch.zeros_like(c_vec)
        t = tau if greedy is not None else torch.ones_like(tau)
        ps, tv = torch.zeros_like(tau), tau
        k = torch.zeros((1, B), dtype=torch.int64, device=dev)
        done = torch.zeros((1, B), dtype=torch.bool, device=dev)
        iters = torch.zeros((1, B), dtype=torch.int32, device=dev)
        gap = torch.full_like(tau, float("inf"))
    else:
        X, Y, t, ps, tv, k, done, iters, gap = state0
        k = k.to(torch.int64)
    if armijo is not None:
        steps = fista_armijo_chunk(matvec, betas, c_vec, a1, a2, btb, chunk,
                                   restart_threshold, armijo)
    else:
        general = fista_general_chunk(matvec, betas, c_vec, tau, thr, a1, a2,
                                      chunk, restart_threshold, greedy, taumin)

        def steps(k0, X, Y, t, ps, tv):
            return (*general(k0, X, Y, t, ps), tv)

    n_groups = -(-B // b_tile)
    group = torch.arange(B, device=dev) // b_tile

    def group_all(row):  # (1, B) bool -> each lane's group all-reduced
        full = torch.ones(n_groups * b_tile, dtype=torch.bool, device=dev)
        full[:B] = row[0]
        return full.view(n_groups, b_tile).all(dim=1)[group][None, :]

    inf = torch.full_like(tau, float("inf"))
    while True:
        live = ~group_all(done) & (k < k_end)
        if not bool(live.any()):
            break
        k_live = k[live]
        k0 = int(k_live[0]) if bool((k_live == k_live[0]).all()) else k
        new = steps(k0, X, Y, t, ps, tv)
        X, Y, t, ps, tv = (torch.where(live, v_new, v)
                           for v_new, v in zip(new, (X, Y, t, ps, tv)))
        k = torch.where(live, k + chunk, k)
        finite = torch.all(torch.isfinite(X), dim=0, keepdim=True)
        gp = torch.where(finite, gram_rel_gap(X, matvec, c_vec, a1, a2, btb),
                         inf)
        open_ = live & ~done
        newly = open_ & ((gp <= tol) | ~finite)
        if greedy is not None:
            # a live lane whose gap did not improve over a whole check
            # window gets its τ halved toward 1/L
            stuck = open_ & ~newly & (gp > 0.9 * gap)
            t = torch.where(stuck, torch.maximum(0.5 * t, taumin), t)
        iters = torch.where(open_, k.to(torch.int32), iters)
        gap = torch.where(open_, gp, gap)
        done = done | newly
    return X, Y, t, ps, tv, k, done, iters, gap
