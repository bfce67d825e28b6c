"""The resident engine of the wide-n window (port of
``fastoptsolver_tpu/kernels/resident.py``).

:func:`fista_gram_resident` runs the whole certified solve of a prebuilt
:class:`GramBatch` in ONE launch of the hand-written Hopper kernel
``csrc/resident.cu`` on a CUDA tensor: each CTA copies the upper triangles of
its lanes' Gram into shared memory once, optionally estimates L against them
(``est_l_iters`` power steps), and iterates there until its lanes are all
certified or ``k_end`` is reached. Features are on threads, and the matvec
over each triangle (``csrc/tri_matvec.cuh``, shared with the build's
``gram_power``) reads the vector as 16-byte broadcasts and walks the
triangle in warp-uniform segments; see the source's note for the design and
the bound. On a CPU tensor it runs the plain twin
:func:`fista_gram_resident_reference`, built from
``_common.certified_solve_body``. Every momentum mode runs, Armijo included,
and a run resumes from its :class:`ResidentSolveState`.

Differences from the reference, forced by the card:

- The reference's lane tile is 128 lanes, its Gram block in VMEM. A Hopper
  block holds 227 KB, so a CTA holds the triangles of :func:`group_lanes`
  lanes (6 at n = 128, 3 at n = 168). Certified lanes iterate until their
  group exits, so ``x`` depends on the grouping: the twin takes ``b_tile``
  (default: the kernel's group), and a checkpoint resumes only under the
  grouping that produced it (``assert_tile_k_uniform``).
- The reference pads lanes to a whole tile; here the last group is ragged
  and its missing lanes count as certified, as the reference's zero lanes
  certify at once.
- The kernel holds only the upper triangle of each Gram, so ``Q[k][i]`` for
  k > i is read as ``Q[i][k]``; the reference reads the full Q. They agree
  on a bit-symmetric Gram (the port's builds give one); the twin reads the
  same triangle, so kernel and twin agree on any Q.

:func:`auto_b_tile_resident` keeps the reference's plan (128 lanes, raising
past n_pad = 168) so that ``fista_vmem.plan_gram_solve`` picks the same
engine in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..batch.fista_gram import BatchFISTAConfig, GramBatch
from ..utils.profiling import launch, span
from . import _build
from ._common import (
    assert_tile_k_uniform,
    certified_solve_body,
    make_matvec,
    power_lambda_max,
)
from .fista_vmem import (
    LANE,
    SUBLANE,
    _certified_result,
    _check_kernel_cfg,
    _round_up,
    _solve_plan,
    _state_rows,
)

# The window of the engine: the reference's single-buffered VMEM bound.
MAX_N = 168
# Shared memory an H100 block may opt into (227 KB): the grouping of the twin
# on a CPU tensor. On a CUDA tensor the library asks the card
# (csrc/resident.cu resident_group). Threads per block, the largest group the
# kernel takes, and the per-lane partial sums of its reductions
# (csrc/resident.cu kMaxGroup, kSums).
SMEM_PER_BLOCK = 232448
MAX_THREADS = 1024
MAX_GROUP = 32
N_SUMS = 6

_DEFAULT_CFG = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


def auto_b_tile_resident(n_pad: int,
                         vmem_budget_bytes: int = 15 * 1024 * 1024) -> int:
    """The reference's lane tile for the resident engine: 128 lanes while
    the single-buffered Gram block and ~6 state planes fit its TPU budget,
    which ends at n_pad = 168; raises past it (the Q-streaming engine takes
    over). Kept so that both packages plan alike; the CUDA kernel groups
    :func:`group_lanes` lanes per CTA."""
    need = (n_pad * n_pad + 8 * n_pad + 4 * SUBLANE) * LANE * 4
    if need > vmem_budget_bytes:
        raise ValueError(
            f"resident kernel: n_pad={n_pad} is past the engine's window "
            f"(n <= {MAX_N}); the Q-streaming kernel (kernels.qstream) "
            "covers wider problems"
        )
    return LANE


def _smem_per_lane(n: int) -> int:
    """Shared memory of one lane in the kernel: two vectors of
    ``round_up(n, 4)`` floats (16-byte aligned, for the matvec's broadcast
    loads), its Gram's upper triangle and the partial sums of its warps."""
    warps = _round_up(n, 32) // 32
    return (2 * _round_up(n, 4) + n * (n + 1) // 2 + warps * N_SUMS) * 4


def group_lanes(n: int) -> int:
    """Lanes per CTA of the kernel on an H100 at feature count n: as many as
    227 KB of shared memory and 1024 threads (``round_up(n, 32)`` per lane)
    hold, at most 32 — 6 at n = 128, 3 at n = 168. The twin's default
    grouping on a CPU tensor; the card's own rule is :func:`kernel_group`."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the resident kernel takes n = 1..{MAX_N}, got n={n}")
    return min(MAX_GROUP, MAX_THREADS // _round_up(n, 32),
               SMEM_PER_BLOCK // _smem_per_lane(n))


def kernel_group(n: int, device: torch.device) -> int:
    """The grouping of a solve on ``device``: on a CUDA device the kernel's
    own, which the library derives from the card's opt-in shared memory
    (``resident_group``); elsewhere :func:`group_lanes`."""
    if device.type != "cuda":
        return group_lanes(n)
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the resident kernel takes n = 1..{MAX_N}, got n={n}")
    with torch.cuda.device(device):
        g = _build.library().resident_group(n)
    if g <= 0:
        _build.check(-g, "resident_group")
    return g


class ResidentSolveState(NamedTuple):
    """Checkpointable state of the resident engine, field for field the
    reference's: ``k`` is per lane (each group exits at its own burst
    boundary) and uniform within a group; ``t``/``ps`` the momentum rows,
    ``tau`` the per-lane Armijo step. Produced by ``fista_gram_resident(...,
    return_state=True)`` and fed back as ``state0``: the continued run is
    bit-identical to an uninterrupted one under the same grouping."""

    X: torch.Tensor  # (n, B)
    Y: torch.Tensor  # (n, B)
    t: torch.Tensor  # (1, B)
    ps: torch.Tensor  # (1, B)
    tau: torch.Tensor  # (1, B)
    k: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32
    gap: torch.Tensor  # (B,)


def _estimate_rows(matvec, c, a1, a2, est_l_iters, l_safety, t_init):
    """τ, the threshold τα₁ and the greedy floor 1/L from the in-kernel
    estimate: ``est_l_iters`` power steps from c, L = 1.02·λ (1 where λ = 0)
    + α₂ (reference resident.py:129-139)."""
    lam = power_lambda_max(matvec, c, est_l_iters)
    L = torch.where(lam > 0.0, l_safety * lam, torch.ones_like(lam)) + a2
    tau = t_init / L
    return tau, tau * a1, 1.0 / L


def upper_symmetric(Q: torch.Tensor) -> torch.Tensor:
    """Q (n, n, B) with each entry below the diagonal replaced by its mirror
    above it: the Gram the kernel reads from its upper triangles. Equal to Q,
    bit for bit, when Q is symmetric."""
    n = Q.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=Q.device).triu()
    return torch.where(upper[:, :, None], Q, Q.transpose(0, 1)).contiguous()


def _plain_run(betas, gb, tau, thr, taumin, state0, *, b_tile, chunk, k_end,
               tol, restart_threshold, greedy, armijo, est_l_iters, l_safety,
               t_init):
    """The twin's arithmetic: the 9-tuple of ``certified_solve_body``,
    against the upper triangles the kernel holds."""
    n = gb.c.shape[0]
    matvec = make_matvec(upper_symmetric(gb.Q), n)
    a1, a2, btb = gb.alpha1[None, :], gb.alpha2[None, :], gb.btb[None, :]
    if est_l_iters is not None:
        tau, thr, taumin = _estimate_rows(matvec, gb.c, a1, a2, est_l_iters,
                                          l_safety, t_init)
    return certified_solve_body(
        matvec, betas, gb.c, tau, thr, a1, a2, btb, taumin, state0,
        b_tile=b_tile, chunk=chunk, k_end=k_end, tol=tol,
        restart_threshold=restart_threshold, greedy=greedy, armijo=armijo,
    )


@launch("resident")
def _launch(betas, gb, tau, thr, taumin, state0, *, b_tile, chunk, k_end,
            tol, restart_threshold, greedy, armijo, est_l_iters, l_safety,
            t_init):
    """One launch of ``resident_solve`` on the current stream; the 9-tuple
    of :func:`_plain_run` with rows ``(B,)`` and ``done`` as int32, as the
    fused kernel's. Raises on any input the kernel does not take and on a
    launch error."""
    n, B = gb.c.shape
    Q = gb.Q
    floats = (("Q", Q), ("c", gb.c), ("tau", tau), ("thr", thr), ("taumin", taumin),
              ("a1", gb.alpha1), ("a2", gb.alpha2), ("btb", gb.btb),
              ("betas", betas))
    ints, ins = (), (None,) * 9
    if state0 is not None:
        # the kernel reads the done row as int32
        ins = (*state0[:6], state0[6].to(torch.int32), *state0[7:])
        floats += tuple(zip(("X0", "Y0", "t0", "ps0", "tau0", "gap0"),
                            (*ins[:5], ins[8])))
        ints = tuple(zip(("k0", "done0", "iters0"), ins[5:8]))
    _build.check_tensors(floats, ints)
    if Q.shape != (n, n, B):
        raise ValueError(f"Q {tuple(Q.shape)} does not match c {(n, B)}")
    if betas.numel() < k_end + chunk:
        raise ValueError("the β table is shorter than k_end + chunk")
    mode, restart, S, shrink, C, eta, max_bt = _build.mode_args(
        restart_threshold, greedy, armijo)
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=Q.device)
    i32 = lambda: torch.empty((B,), dtype=torch.int32, device=Q.device)
    out = (f(n, B), f(n, B), f(B), f(B), f(B), i32(), i32(), i32(), f(B))
    _build.call(
        "resident_solve", Q.device, Q, gb.c, tau, thr, gb.alpha2, gb.alpha1,
        gb.btb, taumin, betas, *ins, *out, n, B, b_tile, chunk, k_end, tol, mode,
        int(armijo is not None), restart, S, shrink, C, eta, max_bt,
        est_l_iters or 0, l_safety, t_init)
    return out


def _solve(run, gb: GramBatch, cfg: BatchFISTAConfig, state0, return_state,
           est_l_iters, l_safety, b_tile):
    """The rows, the state's layout and the result around one run (the
    kernel's or the twin's)."""
    _check_kernel_cfg(cfg)
    if cfg.check_every <= 0:
        raise ValueError(
            "the resident kernel certifies in-kernel and needs "
            "check_every > 0; for fixed-iteration runs use fista_gram_vmem"
        )
    n, B = gb.c.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(
            f"resident engine: n={n} is past its window (n <= {MAX_N}); the "
            "Q-streaming engine (kernels.qstream via fista_gram_vmem) covers "
            "wider problems"
        )
    if b_tile is None:
        b_tile = kernel_group(n, gb.c.device)
    # contiguous fields: the twin's sums follow the layout, and a resumed run
    # must add in the order of the run it continues
    gb = GramBatch(*(v.contiguous() for v in (gb.Q, gb.c, gb.btb, gb.alpha1,
                                              gb.alpha2, gb.L)))
    dev = gb.c.device
    with span("fos.plan"):
        plan = _solve_plan(cfg, dev)
        tau = (plan.t_init / gb.L)[None, :].contiguous()
        thr = (tau * gb.alpha1[None, :]).contiguous()
        taumin = (1.0 / gb.L)[None, :].contiguous()
        rows = None
        if state0 is not None:
            assert_tile_k_uniform(state0.k, B, b_tile)
            rows = _state_rows(state0, B, dev, torch.float32)
    out = run(plan.betas, gb, tau, thr, taumin, rows, b_tile=b_tile,
              est_l_iters=est_l_iters, l_safety=l_safety, **plan.static())
    with span("fos.result"):
        return _certified_result(out, cfg.rel_gap_tol,
                                 ResidentSolveState if return_state else None)


def fista_gram_resident_reference(gb: GramBatch, cfg: BatchFISTAConfig = _DEFAULT_CFG,
                                  state0: ResidentSolveState | None = None,
                                  return_state: bool = False,
                                  est_l_iters: int | None = None,
                                  l_safety: float = 1.02,
                                  b_tile: int | None = None):
    """The plain twin of :func:`fista_gram_resident` on a tensor of any
    device, with ``b_tile`` lanes per group (default: the kernel's on that
    device, :func:`kernel_group`; the reference groups 128). It reads each
    Gram's upper triangle, as the kernel does."""
    return _solve(_plain_run, gb, cfg, state0, return_state, est_l_iters,
                  l_safety, b_tile)


def fista_gram_resident(
    gb: GramBatch,
    cfg: BatchFISTAConfig = _DEFAULT_CFG,
    interpret: bool = False,
    state0: ResidentSolveState | None = None,
    return_state: bool = False,
    est_l_iters: int | None = None,
    l_safety: float = 1.02,
):
    """Certified solve with each group's Gram held on-chip for the whole
    solve: one launch of the resident kernel on a CUDA tensor, the plain
    twin on a CPU tensor (``interpret=True`` asks for the twin and raises
    with a CUDA tensor). Every momentum mode runs, Armijo included;
    ``check_every > 0`` is required. The upper triangle of each Gram is
    authoritative (``Q[k][i]``, k > i, is read as ``Q[i][k]``); the
    reference reads the full Q, so the two agree on a symmetric Gram.

    ``est_l_iters``: estimate L in-kernel (power steps from c, L = 1.02·λ +
    α₂, τ = t_init/L) and ignore ``gb.L``, so the Gram may be built with
    ``make_gram_batch(..., estimate_l=False)``. A resumed state needs the
    same ``est_l_iters`` as the run that produced it, and the grouping that
    produced it (the kernel's on a CUDA tensor)."""
    _build.refuse_interpret(interpret, gb.Q.is_cuda)
    run = _launch if gb.Q.is_cuda else _plain_run
    return _solve(run, gb, cfg, state0, return_state, est_l_iters, l_safety,
                  None)
