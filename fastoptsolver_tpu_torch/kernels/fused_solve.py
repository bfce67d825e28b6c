"""The certified batched-lasso pipeline in one kernel launch (port of
``fastoptsolver_tpu/kernels/fused_solve.py``).

Raw ``A (n, m, B)``, ``b (m, B)`` and α in, certified ``BatchResult`` out;
the Gram never exists in device memory. On a CUDA tensor
:func:`solve_lasso_fused` launches the hand-written Hopper kernel
``csrc/fused_solve.cu`` (one thread per instance, one CTA per ``b_tile``
instances; see the source's note for its design and bound). On a CPU tensor
it runs the plain PyTorch twin :func:`fused_solve_reference`, built from
``kernels/_common.py`` — the same arithmetic, tile by tile.

Scope of this port: fixed (table-β) momentum, ``nesterov`` or ``delta``.
Adaptive restart, greedy momentum, Armijo backtracking and checkpoint/resume
(``FusedSolveState``) are still to port (ROADMAP Queue 1 item 4); the guards
refuse them, and the router sends them to the torch driver. Both ``overlap``
values run the same kernel: on an SM, resident CTAs overlap one CTA's solve
with another's loads in hardware, which the TPU's ``_overlap_kernel`` had to
pipeline by hand.
"""
from __future__ import annotations

import functools

import torch

from ..batch.fista_gram import BatchFISTAConfig, BatchResult, _lane_vector
from . import _build
from ._common import (
    augmented_gram,
    certified_solve_body,
    make_matvec,
    power_lambda_max,
)
from .fista_vmem import _check_kernel_cfg, momentum_betas
from .gram_build import _round_up

# Feature counts the CUDA template is instantiated for (csrc/fused_solve.cu).
MAX_N = 8
# Default lanes per CTA; b_tile must be a multiple of 32 in 32..256.
B_TILE = 128
# Launches of the CUDA kernel by this process; incremented only where it launches.
LAUNCHES = 0


def _check_fused_cfg(cfg: BatchFISTAConfig, overlap: bool = False) -> None:
    """Refuse what the fused kernel does not implement. ``overlap`` is
    accepted for the reference signature; both variants are one kernel."""
    del overlap
    _check_kernel_cfg(cfg, backtracking_ok=False)
    if cfg.adaptive_restart or cfg.momentum == "greedy":
        raise NotImplementedError(
            "the fused CUDA kernel implements fixed (table-β) momentum only; "
            "adaptive restart and greedy momentum run on the torch driver "
            "until they are ported (ROADMAP Queue 1 item 4)"
        )
    if cfg.check_every <= 0:
        raise ValueError(
            "the single-launch fused kernel certifies in-kernel and needs "
            "check_every > 0; for fixed-iteration runs use the torch driver"
        )


def auto_tiles_fused(n: int, m: int):
    """``(b_tile, m_tile)`` for the fused kernel. The Hopper envelope is the
    template range: Q (n²), c, X, Y and the pair sums live in one thread's
    registers, and at n = 8 that is ~150 of the 255 a thread may hold; wider
    problems go to the torch driver. ``m_tile`` is always ``m``: each thread
    walks all its rows, so there is no row tiling to choose."""
    if not 1 <= n <= MAX_N:
        raise ValueError(
            f"fused build+solve kernel: n={n} is outside the instantiated "
            f"range 1..{MAX_N} (per-thread registers); use the torch driver"
        )
    return B_TILE, m


def _plain_run(A, b, a1, a2, betas, *, b_tile: int, pl_iters: int,
               l_safety: float, t_init: float, chunk: int, k_end: int,
               tol: float):
    """The twin's arithmetic, with the kernel's raw outputs ``(X (n, B),
    iters (B,) int32, gap (B,), done (B,) int32)``. Lanes are zero-padded to
    a whole number of tiles with α = 0, so padded lanes certify at once, as
    in the reference."""
    n, m, B = A.shape
    pB = _round_up(B, b_tile) - B
    if pB:
        A = torch.nn.functional.pad(A, (0, pB))
        b = torch.nn.functional.pad(b, (0, pB))
        a1 = torch.nn.functional.pad(a1, (0, pB))
        a2 = torch.nn.functional.pad(a2, (0, pB))
    a1 = a1[None, :]
    a2 = a2[None, :]
    Q, c_vec, btb = augmented_gram(A, b)
    matvec = make_matvec(Q, n)
    lam = power_lambda_max(matvec, c_vec, pl_iters)
    L = torch.where(lam > 0.0, l_safety * lam, torch.ones_like(lam)) + a2
    tau = t_init / L
    thr = tau * a1
    X, iters, gap, done = certified_solve_body(
        matvec, betas.cpu(), c_vec, tau, thr, a1, a2, btb, b_tile=b_tile,
        chunk=chunk, k_end=k_end, tol=tol,
    )
    return (X[:, :B], iters[0, :B], gap[0, :B],
            done[0, :B].to(torch.int32))


def _launch(A, b, a1, a2, betas, *, b_tile: int, pl_iters: int,
            l_safety: float, t_init: float, chunk: int, k_end: int,
            tol: float):
    """Launch ``fused_lasso_solve`` on the current stream; same outputs as
    :func:`fused_solve_reference`. Raises on any input the kernel does not
    take and on a launch error."""
    global LAUNCHES
    n, m, B = A.shape
    for name, t in (("A", A), ("b", b), ("alpha1", a1), ("alpha2", a2),
                    ("betas", betas)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    if b.shape != (m, B) or a1.shape != (B,) or a2.shape != (B,):
        raise ValueError(f"shapes do not match A {tuple(A.shape)}: b "
                         f"{tuple(b.shape)}, alpha {tuple(a1.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the fused CUDA kernel is instantiated for "
                         f"n = 1..{MAX_N}, got n={n}")
    if b_tile % 32 or not 32 <= b_tile <= 256:
        raise ValueError(f"b_tile must be a multiple of 32 in 32..256, got {b_tile}")
    if betas.numel() < k_end:
        raise ValueError("the β table is shorter than k_end")
    lib = _build.library()
    X = torch.empty((n, B), dtype=A.dtype, device=A.device)
    iters = torch.empty((B,), dtype=torch.int32, device=A.device)
    gap = torch.empty((B,), dtype=A.dtype, device=A.device)
    done = torch.empty((B,), dtype=torch.int32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.fused_lasso_solve(
            A.data_ptr(), b.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            betas.data_ptr(), X.data_ptr(), iters.data_ptr(), gap.data_ptr(),
            done.data_ptr(), n, m, B, b_tile, pl_iters, l_safety, t_init,
            chunk, k_end, tol, stream,
        )
    _build.check(err, "fused_lasso_solve")
    LAUNCHES += 1
    return X, iters, gap, done


def _result(X, iters, gap, done, tol: float) -> BatchResult:
    failed = ~torch.all(torch.isfinite(X), dim=0)
    return BatchResult(
        x=X.T,
        iters=iters,
        rel_gap=gap,
        n_iters_total=torch.max(iters),
        converged=(done > 0) & (gap <= tol) & ~failed,
        failed=failed,
    )


@functools.lru_cache(maxsize=16)
def _beta_table(k_end: int, cfg: BatchFISTAConfig) -> torch.Tensor:
    """The host β table for iterations 0..k_end-1, built once per (k_end,
    cfg): the recurrence is a Python loop of k_end steps that would
    otherwise run, with the card idle, before every launch. Callers only
    read it."""
    return momentum_betas(0, k_end, 1.0, cfg)[0]


def _plan(A, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile) -> dict:
    """Per-lane α vectors, the β table and the static launch parameters,
    shared by the kernel and its twin."""
    if A.dim() != 3:
        raise ValueError("A must be (n, m, B)")
    n, m, B = A.shape
    auto_bt, _ = auto_tiles_fused(n, m)
    chunk = cfg.check_every
    # k_end is the absolute iteration ceiling (max_iter rounded up to a burst)
    k_end = -(-cfg.max_iter // chunk) * chunk
    return dict(
        a1=_lane_vector(alpha1, B, A), a2=_lane_vector(alpha2, B, A),
        betas=_beta_table(max(k_end, 1), cfg).to(A.device),
        # a tile never spans more than the batch, rounded as the reference rounds
        b_tile=min(auto_bt if b_tile is None else b_tile, _round_up(B, 128)),
        pl_iters=(32 if n <= 7 else 96) if pl_iters is None else pl_iters,
        l_safety=l_safety, t_init=cfg.t_init_factor, chunk=chunk,
        k_end=k_end, tol=cfg.rel_gap_tol,
    )


_DEFAULT_CFG = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


def fused_solve_reference(
    A: torch.Tensor,
    b: torch.Tensor,
    alpha1,
    alpha2=0.0,
    cfg: BatchFISTAConfig = _DEFAULT_CFG,
    pl_iters: int | None = None,
    l_safety: float = 1.02,
    b_tile: int | None = None,
) -> BatchResult:
    """The plain PyTorch twin of the fused kernel on a tensor of any device:
    the same ``BatchResult`` for the same inputs and lane grouping
    ``b_tile``. Certified lanes keep iterating until their tile exits, so a
    different ``b_tile`` gives a different ``x``."""
    _check_fused_cfg(cfg)
    plan = _plan(A, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile)
    return _result(*_plain_run(A, b, **plan), cfg.rel_gap_tol)


def solve_lasso_fused(
    A: torch.Tensor,  # (n, m, B) feature-leading
    b: torch.Tensor,  # (m, B)
    alpha1,
    alpha2=0.0,
    cfg: BatchFISTAConfig = _DEFAULT_CFG,
    pl_iters: int | None = None,
    l_safety: float = 1.02,
    b_tile: int | None = None,
    interpret: bool = False,
    overlap: bool | None = None,
    state0=None,
    return_state: bool = False,
) -> BatchResult:
    """Certified batched lasso, raw ``(A, b, α)`` to solutions: one kernel
    launch on a CUDA tensor, the plain twin on a CPU tensor.

    ``interpret=True`` asks for the plain twin, which is what a CPU tensor
    gets; with a CUDA tensor it raises. ``overlap`` selects nothing (one
    kernel serves both reference variants). ``b_tile`` is the CTA size and
    the twin's lane grouping (default 128). The reference's TPU tiling knobs
    ``m_tile`` and ``split_k`` have no counterpart."""
    _check_fused_cfg(cfg, overlap=bool(overlap))
    if state0 is not None or return_state:
        raise NotImplementedError(
            "checkpoint/resume of the fused engine (FusedSolveState) is not "
            "ported yet (ROADMAP Queue 1 item 4)"
        )
    if A.is_cuda and interpret:
        raise ValueError("interpret=True runs the plain twin on a CPU tensor; "
                         "A is a CUDA tensor")
    plan = _plan(A, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile)
    run = _launch if A.is_cuda else _plain_run
    return _result(*run(A, b, **plan), cfg.rel_gap_tol)
