"""The burst engine of the two-kernel path (port of
``fastoptsolver_tpu/kernels/fista_vmem.py``).

:func:`fista_gram_vmem` solves a prebuilt :class:`GramBatch` in bursts of
``check_every`` FISTA iterations. On a CUDA tensor each burst is one launch of
the hand-written Hopper kernel ``csrc/fista_burst.cu``, which holds each
lane's Q in shared memory for the burst (see its note for the design and the
bound); on a CPU tensor it is the plain twin
:func:`_burst_reference`, built from ``kernels/_common.py``. :func:`make_burst`
makes the bursts of one solve: its first launch gathers each lane's Gram
from Q and, where a later burst follows, stores it to a slab, one contiguous
block a CTA, which every later launch reads in one bulk copy. Every momentum
mode runs in the burst: fixed (nesterov or delta, β from a host table at the
absolute iteration), adaptive restart, greedy, and the masked per-lane Armijo
search. With ``check_every > 0`` each burst ends with the per-lane relative
duality gap, and the host loop (:func:`_solve_on_device`) keeps the
certification record: non-finite quarantine, the greedy stuck-lane shrink,
the burst-boundary ``iters``, and the exit once every lane is certified.

Differences from the reference, all forced by the framework or the card:

- The reference runs the whole burst loop as one jitted ``while_loop`` on the
  device. Here it is a Python loop with one host sync per burst (the
  all-done test); the card idles for that sync and the next launch.
- Lanes are not padded: the kernel masks its ragged last CTA, and no lane's
  result depends on its neighbours, so ``b_tile`` selects nothing (it is
  kept for the reference's signature and plans, :func:`auto_b_tile`).
- The window: the burst kernel takes n ≤ 104, the reference's own burst
  ceiling. Past it :func:`plan_gram_solve` climbs the reference's ladder:
  the resident engine (``kernels.resident``, one launch per solve) for
  certified configs up to n = 168, the Q-streaming engine
  (``kernels.qstream``, one launch per burst under this module's host loop)
  beyond, and for ``check_every <= 0`` in the window; Armijo past the window
  raises, which sends the router to the torch driver.
- :func:`fista_gram_vmem_adaptive`, the reference's per-tile adaptive
  kernel, is an entry onto the resident kernel (external L, no Armijo, no
  state): the same certified loop in one launch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..batch.fista_gram import (
    BatchFISTAConfig,
    BatchResult,
    GramBatch,
    _rel_gap,
)
from ..utils.profiling import count, launch, span
from . import _build
from ._common import (
    fista_armijo_chunk,
    fista_general_chunk,
    gram_rel_gap,
    make_matvec,
)

LANE = 128
SUBLANE = 8
# The burst engine's feature window (the reference's vmem ceiling, n_pad < 112).
MAX_N = 104


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_kernel_cfg(cfg: BatchFISTAConfig, backtracking_ok: bool = True) -> None:
    """Entry guard shared by the kernel paths: a config option a kernel does
    not implement fails loudly, never silently degrades to another algorithm
    (the torch driver, batch/fista_gram.py, implements everything)."""
    if cfg.backtracking and not backtracking_ok:
        raise NotImplementedError(
            "backtracking runs on the burst kernel (kernels.fista_vmem) or "
            "the torch driver (batch.fista_gram.fista_gram_batch) — not on "
            "this kernel"
        )
    if cfg.adaptive_restart and cfg.momentum != "nesterov":
        raise ValueError("adaptive restart applies to nesterov momentum only")


def _armijo_static(cfg: BatchFISTAConfig):
    """Static (C, η, max_backtracks) triple for an in-kernel Armijo search,
    or None when the config doesn't backtrack."""
    if not cfg.backtracking:
        return None
    return (cfg.armijo_c, cfg.ls_eta, cfg.max_backtracks)


def momentum_betas(k0: int, n_steps: int, t0: float, cfg: BatchFISTAConfig):
    """Host-side β_k table for global iterations k0..k0+n_steps-1 plus the
    Nesterov scalar to resume from, built in numpy exactly as the reference
    builds it, as a CPU tensor; the caller copies it to the card once."""
    betas = np.empty(n_steps, np.float32)
    t = t0
    if cfg.momentum == "delta":
        for i in range(n_steps):
            k_ref = k0 + i + 1  # reference counts from 1
            betas[i] = k_ref / (k_ref + 1.0 + cfg.delta)
    else:
        for i in range(n_steps):
            t_next = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
            betas[i] = (t - 1.0) / t_next
            t = t_next
    return torch.from_numpy(betas), t


@functools.lru_cache(maxsize=16)
def _beta_table(k_end: int, cfg: BatchFISTAConfig) -> torch.Tensor:
    """The host β table for iterations 0..k_end-1, built once per (k_end,
    cfg): the recurrence is a Python loop of k_end steps that would
    otherwise run, with the card idle, before every solve. Callers only
    read it."""
    return momentum_betas(0, k_end, 1.0, cfg)[0]


def _schedule(cfg, state0):
    """``(k0, chunk, n_bursts)``: a solve's first iteration, its burst
    length and its number of bursts (at most; the certified loop may exit
    early)."""
    k0 = int(state0.k) if state0 is not None else 0
    remaining = max(cfg.max_iter - k0, 0)
    chunk = cfg.check_every if cfg.check_every > 0 else max(remaining, 1)
    return k0, chunk, -(-remaining // chunk)


class SolvePlan(NamedTuple):
    """What an engine takes from its config, derived once by
    :func:`_solve_plan` for the fused, resident, burst and Q-streaming
    engines alike."""

    k0: int  # the first iteration: a burst engine's resumed k, else 0
    chunk: int  # iterations a burst, and between two certificates
    n_bursts: int  # bursts at most
    k_end: int  # k0 + n_bursts·chunk, the iteration ceiling
    tol: float
    t_init: float  # τ·L at the start: greedy_xi under greedy, else t_init_factor
    restart_threshold: float | None  # None unless adaptive restart
    greedy: tuple | None  # (S, shrink) under greedy momentum
    armijo: tuple | None  # :func:`_armijo_static`
    betas: torch.Tensor  # the β table on the device, one chunk past k_end

    def static(self) -> dict:
        """The static arguments of the per-lane-k engines (fused, resident)."""
        return dict(chunk=self.chunk, k_end=self.k_end, tol=self.tol,
                    t_init=self.t_init, restart_threshold=self.restart_threshold,
                    greedy=self.greedy, armijo=self.armijo)


def _solve_plan(cfg: BatchFISTAConfig, device, state0=None) -> SolvePlan:
    """The one rule from ``cfg`` to an engine's plan: :func:`_schedule`
    (from ``state0``'s k on a burst engine; a per-lane-k engine passes
    none), the momentum mode and the β table, copied to ``device`` once a
    call. The table runs one chunk past ``k_end``: a resumed per-lane tile
    may start off the burst grid."""
    k0, chunk, n_bursts = _schedule(cfg, state0)
    k_end = k0 + n_bursts * chunk
    greedy = ((cfg.greedy_S, cfg.greedy_shrink) if cfg.momentum == "greedy"
              else None)
    betas = _beta_table(k_end + chunk, cfg)
    # a copy from pageable memory waits for the stream: behind a Gram build,
    # this is where the host first waits for the card
    with span("fos.sync"):
        betas = betas.to(device)
    return SolvePlan(
        k0=k0, chunk=chunk, n_bursts=n_bursts, k_end=k_end, tol=cfg.rel_gap_tol,
        # greedy starts from the overshoot ξ/L (the reference's step_factor)
        t_init=cfg.greedy_xi if greedy is not None else cfg.t_init_factor,
        restart_threshold=cfg.restart_threshold if cfg.adaptive_restart else None,
        greedy=greedy, armijo=_armijo_static(cfg), betas=betas)


def _state_rows(state0, B: int, device, dtype):
    """A per-lane-k engine's checkpoint as its runs' 9-tuple: planes
    ``(n, B)`` and rows ``(1, B)`` on ``device``, contiguous (the twins'
    sums follow the layout, and a resumed run must add in the order of the
    run it continues)."""
    mv = lambda v, dt=dtype: v.to(device=device, dtype=dt).reshape(-1, B).contiguous()
    return (mv(state0.X), mv(state0.Y), mv(state0.t), mv(state0.ps),
            mv(state0.tau), mv(state0.k, torch.int32), mv(state0.done, torch.bool),
            mv(state0.iters, torch.int32), mv(state0.gap))


def _certified_result(out, tol: float, state_type=None):
    """The ``BatchResult`` of a per-lane-k engine's run from its 9-tuple
    ``(X, Y, t, ps, tau, k, done, iters, gap)`` (rows ``(B,)`` from a kernel,
    ``(1, B)`` from a twin), and with ``state_type`` its checkpoint."""
    X, Y, t, ps, tv, k, done, iters, gap = out
    done, iters, gap = done.reshape(-1) > 0, iters.reshape(-1), gap.reshape(-1)
    failed = ~torch.all(torch.isfinite(X), dim=0)
    result = BatchResult(x=X.T, iters=iters, rel_gap=gap,
                         n_iters_total=torch.max(iters),
                         converged=done & (gap <= tol) & ~failed, failed=failed)
    if state_type is None:
        return result
    row = lambda v: v.reshape(1, -1)
    return result, state_type(X=X, Y=Y, t=row(t), ps=row(ps), tau=row(tv),
                              k=k.reshape(-1).to(torch.int32), done=done,
                              iters=iters, gap=gap)


def auto_b_tile(n_pad: int, vmem_budget_bytes: int = 12 * 1024 * 1024) -> int:
    """The reference's lane tile for the burst engine: the largest multiple
    of 128 lanes, clamped to [128, 1024], whose double-buffered Q tile fits
    its TPU budget. Kept so that :func:`plan_gram_solve` returns the same
    plan in both packages; here no result depends on it (the CUDA kernel
    groups as many lanes a CTA as its shared memory holds). Raises past the
    window (n_pad ≥ 112, n > 104)."""
    fit = vmem_budget_bytes // (2 * n_pad * n_pad * 4)
    if fit < LANE:
        raise ValueError(
            f"n_pad={n_pad} is past the burst engine's window (n <= {MAX_N}); "
            "wider problems run on the resident engine (kernels.resident, "
            "n <= 168) or the Q-streaming engine (kernels.qstream)"
        )
    return int(max(LANE, min(1024, (fit // LANE) * LANE)))


def plan_gram_solve(n: int, cfg: BatchFISTAConfig) -> tuple[str, int, int]:
    """The kernel engine for a Gram-form solve at feature count ``n``, the
    reference's ladder and plans:

    - ``("vmem", b_tile, 0)`` for n ≤ 104 (the burst engine);
    - ``("resident", 128, 0)`` for n ≤ 168 with ``check_every > 0`` (every
      mode, Armijo included);
    - ``("qstream", b_tile, g_planes)`` beyond, and for ``check_every <= 0``
      in the window, up to n = 1016.

    Raises ``NotImplementedError`` for Armijo where Q must stream and
    ``ValueError`` past 1016; the router falls back to the torch driver on
    exactly these errors."""
    n_pad = _round_up(max(n, SUBLANE), SUBLANE)
    try:
        return "vmem", auto_b_tile(n_pad), 0
    except ValueError as vmem_err:
        if cfg.check_every > 0:
            from .resident import auto_b_tile_resident

            try:
                return "resident", auto_b_tile_resident(n_pad), 0
            except ValueError:
                pass
        if cfg.backtracking:
            raise NotImplementedError(
                "at this width the Armijo search needs the resident engine, "
                "which covers n <= 168 for certified configs "
                "(check_every > 0); past the window, or with "
                "check_every <= 0, backtracking runs on the torch driver "
                "(batch.fista_gram.fista_gram_batch)"
            ) from vmem_err
        from .qstream import auto_tiles_qstream

        bt, g = auto_tiles_qstream(n_pad)
        return "qstream", bt, g


class VmemSolveState(NamedTuple):
    """Checkpointable state of the burst engine, field for field the
    reference's: ``t``/``ps`` are the per-lane momentum rows (Nesterov
    scalar and previous step norm; per-lane τ and first-step norm under
    greedy; the fixed modes resume through the β table indexed by ``k``),
    ``tau`` the per-lane Armijo step, and ``done``/``iters``/``gap`` the
    certification record. Produced by ``fista_gram_vmem(...,
    return_state=True)`` and fed back as ``state0``: the continued run is
    bit-identical to an uninterrupted one."""

    X: torch.Tensor  # (n, B)
    Y: torch.Tensor  # (n, B)
    t: torch.Tensor  # (1, B)
    ps: torch.Tensor  # (1, B)
    tau: torch.Tensor  # (1, B) — per-lane Armijo step row
    k: torch.Tensor  # () int32 — iterations completed
    done: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32 — burst-boundary certification counts
    gap: torch.Tensor  # (B,) — last certified per-lane relative gap


def _burst_reference(betas, k0, Q, c, tau, thr, a2, a1, btb, X, Y, t, ps,
                     taumin=None, tauv=None, *, n_steps, with_gap=False,
                     restart_threshold=None, greedy=None, armijo=None):
    """The plain twin of one burst on tensors of any device; rows are
    ``(1, B)``. Returns ``(X, Y, t, ps, tauv, gap)``: ``t``/``ps`` pass
    through under fixed momentum, ``tauv`` unless ``armijo``; ``gap`` is the
    per-lane relative duality gap of the final X when ``with_gap``, else
    zeros."""
    matvec = make_matvec(Q, Q.shape[0])
    betas = betas.cpu()
    if armijo is not None:
        steps = fista_armijo_chunk(matvec, betas, c, a1, a2, btb, n_steps,
                                   restart_threshold, armijo)
        X, Y, t, ps, tauv = steps(k0, X, Y, t, ps, tauv)
    else:
        steps = fista_general_chunk(matvec, betas, c, tau, thr, a1, a2, n_steps,
                                    restart_threshold, greedy, taumin)
        X, Y, t, ps = steps(k0, X, Y, t, ps)
    gap = (gram_rel_gap(X, matvec, c, a1, a2, btb) if with_gap
           else torch.zeros_like(tau))
    return X, Y, t, ps, tauv, gap


def slab_floats(n: int, B: int) -> int:
    """The floats of the slab of a solve on ``B`` lanes of width ``n``:
    ceil(B / G)·G lanes (G lanes a CTA) of n² rounded up to 4 floats
    (``fista_burst_slab_floats`` in C)."""
    return _build.library().fista_burst_slab_floats(n, B)


@functools.lru_cache(maxsize=None)
def ctas_per_sm(n: int, device: torch.device) -> int:
    """The burst kernel's CTAs at width ``n`` that one SM of the CUDA
    ``device`` holds (``fista_burst_ctas_per_sm`` in C), asked of the card
    once per device and width; 0 outside the window."""
    with torch.cuda.device(device):
        got = _build.library().fista_burst_ctas_per_sm(n)
    _build.check(max(-got, 0), "fista_burst_ctas_per_sm")
    return got


def _burst_args(kernel: str, max_n: int, betas, k0, Q, c, X, Y, rows, taumin, extra, *,
                n_steps, restart_threshold, greedy, armijo):
    """The checks of both burst kernels' wrappers (``fista_burst``,
    ``qstream_burst``; the kernel named by ``kernel`` takes ``n ≤ max_n``):
    ``rows``, ``(name, row)`` pairs of one value a lane, with ``taumin``
    under greedy, and ``extra`` tensors are float32 CUDA tensors on Q's
    device, the fixed modes' β table covers the burst. Returns
    :func:`_build.mode_args`."""
    n, B = c.shape
    if greedy is not None:
        rows += (("taumin", taumin),)
    _build.check_tensors((("Q", Q), ("c", c), ("X", X), ("Y", Y), ("betas", betas))
                         + rows + extra)
    if Q.shape != (n, n, B) or X.shape != (n, B) or Y.shape != (n, B):
        raise ValueError(f"shapes do not match: Q {tuple(Q.shape)}, c {(n, B)}, "
                         f"X {tuple(X.shape)}, Y {tuple(Y.shape)}")
    for name, v in rows:
        if v.numel() != B:
            raise ValueError(f"{name} must hold {B} lanes, got {tuple(v.shape)}")
    if not 1 <= n <= max_n:
        raise ValueError(f"the {kernel} kernel takes n = 1..{max_n}, got n={n}")
    args = _build.mode_args(restart_threshold, greedy, armijo)
    if args[0] == 0 and betas.numel() < k0 + n_steps:
        raise ValueError("the β table is shorter than k0 + n_steps")
    return args


@launch("burst")
def _launch_burst(betas, k0, Q, c, tau, thr, a2, a1, btb, X, Y, t, ps,
                  taumin=None, tauv=None, *, n_steps, with_gap=False,
                  restart_threshold=None, greedy=None, armijo=None, S=None,
                  slab_ready=False):
    """Launch ``fista_burst`` on the current stream; the same outputs as
    :func:`_burst_reference`. Raises on any input the kernel does not take
    and on a launch error.

    ``S``, the slab (:func:`slab_floats` floats on Q's device), changes only
    how the Grams reach the kernel, never a bit of the result: with
    ``slab_ready`` the launch reads them from ``S``, which an earlier launch
    on the same Q wrote; without, it gathers them from Q and stores them to
    ``S``. With no slab it gathers and stores nothing."""
    if S is None and slab_ready:
        raise ValueError("slab_ready needs the slab S")
    rows = (("tau", tau), ("thr", thr), ("a2", a2), ("a1", a1), ("btb", btb),
            ("t", t), ("ps", ps), ("tauv", tauv))
    mode, restart, gS, shrink, C, eta, max_bt = _burst_args(
        "burst", MAX_N, betas, k0, Q, c, X, Y, rows, taumin, () if S is None else (("S", S),),
        n_steps=n_steps, restart_threshold=restart_threshold, greedy=greedy, armijo=armijo)
    n, B = c.shape
    if S is not None and S.numel() != slab_floats(n, B):
        raise ValueError(f"S must hold {slab_floats(n, B)} floats, got {S.numel()}")
    Xo, Yo = torch.empty_like(X), torch.empty_like(Y)
    to, pso, tauvo, gap = (torch.empty_like(tau) for _ in range(4))
    _build.call(
        "fista_burst", Q.device, Q, S, c, tau, thr, a2, a1, btb, X, Y, t, ps,
        taumin if greedy is not None else None, tauv, betas, Xo, Yo, to, pso,
        tauvo, gap, n, B, n_steps, k0, mode, int(armijo is not None),
        int(with_gap), 0 if S is None else 2 if slab_ready else 1, restart, gS,
        shrink, C, eta, max_bt)
    return Xo, Yo, to, pso, tauvo, gap


def make_burst(Q: torch.Tensor, n_bursts: int):
    """The burst of a solve of ``n_bursts`` bursts on ``Q``. On a CUDA
    tensor, a closure over :func:`_launch_burst`: where a later burst
    follows, the first launch stores the Grams it gathers to a slab made
    then, and every later launch reads them from it (the counters
    ``burst_slab_writes`` and ``burst_slab_reads``); a one-burst solve
    gathers and stores nothing. Where an SM holds two or more of the
    kernel's CTAs at Q's width (:func:`ctas_per_sm`), each launch counts in
    ``burst_paired_launches``. On a CPU tensor, the plain twin."""
    if not Q.is_cuda:
        return _burst_reference
    slab = None
    paired = ctas_per_sm(Q.shape[0], Q.device) >= 2

    def burst(*args, **kw):
        nonlocal slab
        if slab is not None:
            out = _launch_burst(*args, S=slab, slab_ready=True, **kw)
            count("burst_slab_reads")
        elif n_bursts > 1:
            n, _, B = Q.shape
            S = torch.empty(slab_floats(n, B), dtype=torch.float32, device=Q.device)
            out = _launch_burst(*args, S=S, **kw)
            slab = S
            count("burst_slab_writes")
        else:
            out = _launch_burst(*args, **kw)
        if paired:
            count("burst_paired_launches")
        return out

    return burst


def _solve_on_device(burst, plan: SolvePlan, Q, c, btb, alpha1, a2v, tau, thr,
                     a2, taumin, state0, *, certify,
                     early_exit: bool = True) -> VmemSolveState:
    """The certified solve: bursts of ``plan.chunk`` iterations with the
    gap check between them, until every lane is certified or
    ``plan.k_end`` iterations have run. One host sync before each burst
    reads the count of lanes not yet certified (``fos.sync``; the counters
    ``burst_lanes``/``burst_lanes_live`` add it up); ``early_exit=False``
    runs every burst and reads nothing. ``state0`` resumes a run exactly:
    the fixed modes index the β table at absolute iterations, the others
    continue from their carried rows, and ``done``/``iters``/``gap`` keep
    the certification record."""
    with span("fos.burst_loop"):
        n, B = c.shape
        k, chunk, greedy, tol = plan.k0, plan.chunk, plan.greedy, plan.tol
        a1row, btbrow = alpha1[None, :], btb[None, :]
        if state0 is None:
            z = lambda *s: torch.zeros(s, dtype=c.dtype, device=c.device)
            X, Y, ps = z(n, B), z(n, B), z(1, B)
            # greedy reinterprets (t, ps) as (per-lane τ, first-step norm)
            t = tau if greedy is not None else torch.ones_like(tau)
            tv = tau
            done = torch.zeros((B,), dtype=torch.bool, device=c.device)
            iters = torch.zeros((B,), dtype=torch.int32, device=c.device)
            gap = torch.full((B,), float("inf"), dtype=c.dtype, device=c.device)
        else:
            mv = lambda v: v.to(device=c.device).contiguous()
            X, Y, t, ps, tv = (mv(v).to(c.dtype) for v in state0[:5])
            done, iters, gap = mv(state0.done), mv(state0.iters), mv(state0.gap)

        def step(X, Y, t, ps, tv, with_gap):
            return burst(plan.betas, k, Q, c, tau, thr, a2, a1row, btbrow, X, Y, t,
                         ps, taumin, tv, n_steps=chunk, with_gap=with_gap,
                         restart_threshold=plan.restart_threshold, greedy=greedy,
                         armijo=plan.armijo)

        if certify and plan.n_bursts > 0:
            inf = torch.full_like(gap, float("inf"))
            while k < plan.k_end:
                if early_exit:
                    with span("fos.sync"):
                        n_live = B - int(done.sum())
                    if not n_live:
                        break
                    count("burst_lanes", B)
                    count("burst_lanes_live", n_live)
                count("bursts")
                X, Y, t, ps, tv, gvec = step(X, Y, t, ps, tv, True)
                k += chunk
                g = gvec[0]
                # quarantine non-finite lanes so the loop exits
                failed = ~torch.all(torch.isfinite(X), dim=0) | torch.isnan(g)
                g = torch.where(failed, inf, g)
                newly = ~done & ((g <= tol) | failed)
                if greedy is not None:
                    # a live lane whose gap did not improve over a whole check
                    # window gets its τ halved toward 1/L
                    stuck = ~done & ~newly & (g > 0.9 * gap)
                    t = torch.where(stuck[None, :], torch.maximum(0.5 * t, taumin), t)
                iters = torch.where(newly | ~done, torch.full_like(iters, k), iters)
                gap = torch.where(done, gap, g)
                done = done | newly
        else:
            # fixed-iteration runs and zero-burst resumes: certify the carried
            # iterate afterwards
            for _ in range(plan.n_bursts):
                count("bursts")
                X, Y, t, ps, tv, _ = step(X, Y, t, ps, tv, False)
                k += chunk
            gb = GramBatch(Q=Q, c=c, btb=btb, alpha1=alpha1, alpha2=a2v, L=alpha1)
            gap = _rel_gap(gb, X)
            done = gap <= tol
            iters = torch.full((B,), k, dtype=torch.int32, device=c.device)
        return VmemSolveState(X=X, Y=Y, t=t, ps=ps, tau=tv,
                              k=torch.tensor(k, dtype=torch.int32), done=done,
                              iters=iters, gap=gap)


def _pad_and_solve(burst, plan: SolvePlan, Q, c, btb, alpha1, alpha2, L, state0,
                   *, certify, early_exit: bool = True):
    """The per-lane rows (τ = t_init/L, threshold τα₁, α₂, the greedy floor
    1/L), the solve and the result, as the reference's function of this
    name; lanes need no padding here (the kernel masks its ragged CTA).
    Returns ``(BatchResult, VmemSolveState)``."""
    with span("fos.plan"):
        Q, c, btb, alpha1, alpha2, L = (v.contiguous() for v in (Q, c, btb, alpha1,
                                                                alpha2, L))
        tau = (plan.t_init / L)[None, :]
        thr = tau * alpha1[None, :]
        a2 = alpha2[None, :]
        taumin = (1.0 / L)[None, :]
    fin = _solve_on_device(burst, plan, Q, c, btb, alpha1, alpha2, tau, thr, a2,
                           taumin, state0, certify=certify, early_exit=early_exit)
    with span("fos.result"):
        failed = ~torch.all(torch.isfinite(fin.X), dim=0)
        result = BatchResult(x=fin.X.T, iters=fin.iters, rel_gap=fin.gap,
                             n_iters_total=fin.k, converged=fin.done & ~failed,
                             failed=failed)
    return result, fin


def _solve(burst, gb, cfg, state0, return_state):
    with span("fos.plan"):
        plan = _solve_plan(cfg, gb.Q.device, state0)
    result, fin = _pad_and_solve(burst, plan, gb.Q, gb.c, gb.btb, gb.alpha1,
                                 gb.alpha2, gb.L, state0,
                                 certify=cfg.check_every > 0)
    return (result, fin) if return_state else result


def _dispatch(gb, cfg, state0, return_state, twin: bool):
    """Run the engine :func:`plan_gram_solve` picks: the resident engine in
    its window unless ``state0`` is a ``VmemSolveState``, which pins the
    Q-streaming engine there as in the reference; otherwise the burst
    driver with the burst or Q-streaming burst. ``twin`` runs every engine's
    plain twin; else each takes its kernel or twin by the tensor's device."""
    from . import qstream, resident

    _check_kernel_cfg(cfg)
    engine = plan_gram_solve(gb.c.shape[0], cfg)[0]
    if engine == "resident" and not isinstance(state0, VmemSolveState):
        solve = (resident.fista_gram_resident_reference if twin
                 else resident.fista_gram_resident)
        return solve(gb, cfg, state0=state0, return_state=return_state)
    if engine == "vmem":
        burst = (_burst_reference if twin
                 else make_burst(gb.Q, _schedule(cfg, state0)[2]))
    else:
        burst = (qstream._qstream_burst_reference if twin
                 else qstream.make_burst(gb.Q))
    return _solve(burst, gb, cfg, state0, return_state)


def fista_gram_vmem_reference(gb: GramBatch, cfg: BatchFISTAConfig = BatchFISTAConfig(),
                              state0: VmemSolveState | None = None,
                              return_state: bool = False):
    """:func:`fista_gram_vmem` with the plain twin of every engine, on a
    tensor of any device: the same result as the kernel route up to f32
    summation order."""
    return _dispatch(gb, cfg, state0, return_state, twin=True)


def fista_gram_vmem(
    gb: GramBatch,
    cfg: BatchFISTAConfig = BatchFISTAConfig(),
    b_tile: int | None = None,
    interpret: bool = False,
    state0: VmemSolveState | None = None,
    return_state: bool = False,
):
    """Solve the batch on the engine :func:`plan_gram_solve` picks: on a
    CUDA tensor the burst kernel (n ≤ 104) or the Q-streaming kernel, one
    launch per burst, or, for certified configs in 104 < n ≤ 168, one launch
    of the resident kernel (``kernels.resident.fista_gram_resident``, whose
    ``ResidentSolveState`` it takes and returns); on a CPU tensor their plain
    twins (``interpret=True`` asks for the twins and raises with a CUDA
    tensor).

    ``cfg.check_every > 0``: bursts of that many iterations, each ending
    with the per-lane gap; the loop exits when every lane is certified
    (``max_iter`` rounds up to a burst). ``check_every <= 0``: one fixed run
    of ``max_iter`` iterations, certified afterwards. Certified lanes keep
    iterating; ``iters`` records the burst at which each lane first
    certified. Every momentum mode runs in the burst kernel; the Q-streaming
    kernel refuses Armijo.

    ``state0`` resumes a previous run exactly (``max_iter`` counts the
    resumed iterations); with ``return_state`` the final state comes back
    with the result. A ``VmemSolveState`` in the resident window pins the
    Q-streaming engine, as in the reference. ``b_tile`` selects nothing (no
    lane of the burst engines depends on another)."""
    del b_tile
    _build.refuse_interpret(interpret, gb.Q.is_cuda)
    return _dispatch(gb, cfg, state0, return_state, twin=False)


def fista_gram_vmem_sharded(
    gb: GramBatch,
    mesh,
    cfg: BatchFISTAConfig = BatchFISTAConfig(),
    axis: str = "batch",
    b_tile: int | None = None,
    interpret: bool = False,
) -> BatchResult:
    """Instance-parallel variant over a ``torch.distributed`` mesh: every
    rank of ``mesh[axis]`` runs the burst engine (n ≤ 104) on its lanes,
    with no communication during the solve. Every rank calls it with the
    whole GramBatch (or one of DTensors sharded on the instance axis).

    As in the reference there is no early exit across ranks: every rank
    runs the full static burst schedule (``max_iter`` rounded up to a
    burst) and ``n_iters_total`` is that schedule's length; certification is
    still per lane. Lanes are padded to 128 a rank (Q = c = 0, L = 1: they
    stay at 0) and the results gathered to every rank. ``b_tile`` selects
    nothing (see :func:`fista_gram_vmem`)."""
    from ..parallel.lanes import LaneLayout

    del b_tile
    _check_kernel_cfg(cfg)
    n = gb.c.shape[0]
    auto_b_tile(_round_up(max(n, SUBLANE), SUBLANE))  # the burst engine's window
    lay = LaneLayout(mesh, axis, gb.c.shape[-1], LANE)
    Q, c, btb, a1, a2, L = (lay.take(v, -1, fill) for v, fill in (
        (gb.Q, 0.0), (gb.c, 0.0), (gb.btb, 0.0), (gb.alpha1, 0.0), (gb.alpha2, 0.0),
        (gb.L, 1.0)))
    _build.refuse_interpret(interpret, Q.is_cuda)
    with span("fos.plan"):
        plan = _solve_plan(cfg, Q.device)
    res, _ = _pad_and_solve(make_burst(Q, plan.n_bursts), plan, Q, c, btb, a1, a2, L,
                            None, certify=cfg.check_every > 0, early_exit=False)
    x = lay.gather(res.x, 0)
    failed = ~torch.all(torch.isfinite(x), dim=1)
    return BatchResult(
        x=x, iters=lay.gather(res.iters), rel_gap=lay.gather(res.rel_gap),
        n_iters_total=torch.tensor(plan.k_end, dtype=torch.int32),
        converged=lay.gather(res.converged) & ~failed, failed=failed)


def fista_gram_vmem_adaptive(
    gb: GramBatch,
    cfg: BatchFISTAConfig = BatchFISTAConfig(),
    b_tile: int | None = None,
    interpret: bool = False,
) -> BatchResult:
    """The reference's per-tile adaptive variant: the whole certified loop
    in one launch, each group of lanes exiting at its own convergence point.
    Here it is an entry onto the resident kernel (``kernels.resident``)
    against the Gram's own L: fresh solves only, ``check_every > 0``,
    adaptive restart and greedy momentum, no Armijo, and the reference's
    window n ≤ 104 (:func:`auto_b_tile` raises past it).

    ``b_tile`` is the twin's lane grouping on a CPU tensor (default: the
    kernel's, ``resident.group_lanes``; the reference groups
    ``auto_b_tile`` lanes); on a CUDA tensor the kernel's group is set by
    shared memory and ``b_tile`` must be None."""
    from . import resident

    _check_kernel_cfg(cfg, backtracking_ok=False)
    if cfg.check_every <= 0:
        raise ValueError("adaptive kernel needs check_every > 0")
    auto_b_tile(_round_up(max(gb.c.shape[0], SUBLANE), SUBLANE))
    _build.refuse_interpret(interpret, gb.Q.is_cuda)
    if gb.Q.is_cuda:
        if b_tile is not None:
            raise ValueError("on a CUDA tensor the resident kernel sets its "
                             "own grouping; b_tile must be None")
        return resident.fista_gram_resident(gb, cfg)
    return resident.fista_gram_resident_reference(gb, cfg, b_tile=b_tile)
