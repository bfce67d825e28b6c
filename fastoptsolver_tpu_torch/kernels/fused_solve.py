"""The certified batched-lasso pipeline in one kernel launch (port of
``fastoptsolver_tpu/kernels/fused_solve.py``).

Raw ``A (n, m, B)``, ``b (m, B)`` and α in, certified ``BatchResult`` out;
the Gram never exists in device memory. On a CUDA tensor
:func:`solve_lasso_fused` launches the hand-written Hopper kernel
``csrc/fused_solve.cu`` (one thread per instance, one CTA per ``b_tile``
instances; see the source's note for its design and bound). On a CPU tensor
it runs the plain PyTorch twin :func:`fused_solve_reference`, built from
``kernels/_common.py`` — the same arithmetic, tile by tile.

Every in-kernel mode of the reference runs: fixed (table-β) momentum,
``nesterov`` or ``delta``; adaptive restart; greedy momentum; the masked
per-lane Armijo search with table-β or restart momentum. A run checkpoints
to a :class:`FusedSolveState` (``return_state=True``) and resumes from it
(``state0=``) bit-exactly. Both ``overlap`` values run the same kernel: on
an SM, resident CTAs overlap one CTA's solve with another's loads in
hardware, which the TPU's ``_overlap_kernel`` had to pipeline by hand; an
explicit ``overlap=True`` still refuses what the reference's overlap variant
refuses (restart, greedy, Armijo, state).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..batch.fista_gram import BatchFISTAConfig, _lane_vector
from ..utils.profiling import launch, span
from . import _build
from ._common import (
    assert_tile_k_uniform,
    augmented_gram,
    certified_solve_body,
    make_matvec,
    power_lambda_max,
)
from .fista_vmem import _certified_result, _check_kernel_cfg, _solve_plan, _state_rows
from .gram_build import _round_up

# Feature counts the CUDA template is instantiated for (csrc/fused_solve.cu).
MAX_N = 8
# Default lanes per CTA; b_tile must be a multiple of 32 in 32..256.
B_TILE = 128


class FusedSolveState(NamedTuple):
    """Checkpointable state of the fused engine, field for field the
    reference's (``solve_lasso_fused(..., return_state=True)`` →
    ``state0=``): the per-lane rows of the solve and a per-lane ``k``
    (iterations completed, uniform within each lane tile, since each tile
    exits at its own burst boundary). Resume rebuilds the Gram from the same
    ``(A, b)``, reinjects the rows and continues the β table from ``k``:
    bit-identical to an uninterrupted run under the same ``b_tile``."""

    X: torch.Tensor  # (n, B)
    Y: torch.Tensor  # (n, B)
    t: torch.Tensor  # (1, B) Nesterov scalar / greedy τ row
    ps: torch.Tensor  # (1, B) previous step norm / greedy first-step row
    tau: torch.Tensor  # (1, B) per-lane Armijo step row
    k: torch.Tensor  # (B,) int32 per-lane iterations completed
    done: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32
    gap: torch.Tensor  # (B,)


def _check_fused_cfg(cfg: BatchFISTAConfig, overlap: bool = False) -> None:
    """The reference's guard: every in-kernel mode runs, Armijo included;
    the overlap variant refuses restart, greedy and Armijo."""
    _check_kernel_cfg(cfg, backtracking_ok=not overlap)
    if overlap and (cfg.adaptive_restart or cfg.momentum == "greedy"):
        raise NotImplementedError(
            "the software-pipelined (overlap) variant implements fixed "
            "momentum only; adaptive restart, greedy momentum, and Armijo "
            "backtracking run on the plain single-launch kernel "
            "(overlap=False)"
        )
    if cfg.check_every <= 0:
        raise ValueError(
            "the single-launch fused kernel certifies in-kernel and needs "
            "check_every > 0; fixed-iteration runs take the burst engine "
            "(fista_vmem) or the torch driver"
        )


def _fits(n: int, m: int, cfg: BatchFISTAConfig) -> bool:
    """Whether the fused kernel takes ``(n, m, cfg)``: its config guard and
    its feature window both pass (the router's first question)."""
    try:
        _check_fused_cfg(cfg)
        auto_tiles_fused(n, m)
    except (NotImplementedError, ValueError):
        return False
    return True


def auto_tiles_fused(n: int, m: int):
    """``(b_tile, m_tile)`` for the fused kernel. The Hopper envelope is the
    template range: Q (n²), c, X, Y and the pair sums live in one thread's
    registers, and ptxas gives the n = 8 fixed instance 126 of the 255 a
    thread may hold (chip_smoke's ``-- ptxas`` lines name each mode's); wider
    problems go to the two-kernel path. ``m_tile`` is always ``m``: each
    thread walks all its rows, so there is no row tiling to choose."""
    if not 1 <= n <= MAX_N:
        raise ValueError(
            f"fused build+solve kernel: n={n} is outside the instantiated "
            f"range 1..{MAX_N} (per-thread registers); the two-kernel path "
            "(gram_build + fista_vmem) takes n <= 104, the torch driver wider "
            "problems"
        )
    return B_TILE, m


def _pad_lanes(state0, pB: int):
    """The state rows padded by ``pB`` lanes, as the reference pads them:
    zero planes, t = τ = 1, done; ``k`` repeats the last lane's, so that the
    padded tile stays uniform."""
    def pad(v, fill):
        return torch.cat([v, torch.full((v.shape[0], pB), fill, dtype=v.dtype,
                                        device=v.device)], dim=1)

    X, Y, t, ps, tv, k, done, iters, gap = state0
    return (pad(X, 0.0), pad(Y, 0.0), pad(t, 1.0), pad(ps, 0.0), pad(tv, 1.0),
            pad(k, int(k[0, -1])), pad(done, True), pad(iters, 0), pad(gap, 0.0))


def _plain_run(A, b, a1, a2, betas, state0=None, *, b_tile: int,
               pl_iters: int, l_safety: float, t_init: float, chunk: int,
               k_end: int, tol: float, restart_threshold=None, greedy=None,
               armijo=None, with_state: bool = False):
    """The twin's arithmetic: the state 9-tuple ``(X (n, B), Y, t, ps, tv,
    k, done, iters, gap)`` of ``certified_solve_body`` (rows ``(1, B)``).
    Lanes are zero-padded to a whole number of tiles with α = 0, so padded
    lanes certify at once, as in the reference."""
    del with_state  # the twin always has the whole state
    n, m, B = A.shape
    pB = _round_up(B, b_tile) - B
    if pB:
        A = torch.nn.functional.pad(A, (0, pB))
        b = torch.nn.functional.pad(b, (0, pB))
        a1 = torch.nn.functional.pad(a1, (0, pB))
        a2 = torch.nn.functional.pad(a2, (0, pB))
        if state0 is not None:
            state0 = _pad_lanes(state0, pB)
    a1 = a1[None, :]
    a2 = a2[None, :]
    Q, c_vec, btb = augmented_gram(A, b)
    if state0 is not None:
        # lane-major planes, as the iterates of the run being continued are
        # (the einsum's Gram is lane-major, and the twin's sums follow the
        # layout of their operands)
        state0 = tuple(v.T.contiguous().T for v in state0)
    matvec = make_matvec(Q, n)
    lam = power_lambda_max(matvec, c_vec, pl_iters)
    L = torch.where(lam > 0.0, l_safety * lam, torch.ones_like(lam)) + a2
    tau = t_init / L
    out = certified_solve_body(
        matvec, betas, c_vec, tau, tau * a1, a1, a2, btb, 1.0 / L, state0,
        b_tile=b_tile, chunk=chunk, k_end=k_end, tol=tol,
        restart_threshold=restart_threshold, greedy=greedy, armijo=armijo,
    )
    return tuple(v[:, :B] for v in out)


@launch("fused")
def _launch(A, b, a1, a2, betas, state0=None, *, b_tile: int, pl_iters: int,
            l_safety: float, t_init: float, chunk: int, k_end: int,
            tol: float, restart_threshold=None, greedy=None, armijo=None,
            with_state: bool = False):
    """Launch ``fused_lasso_solve`` on the current stream; the same 9-tuple
    as :func:`_plain_run` (rows ``(B,)``; ``Y, t, ps, tv, k`` None unless
    ``with_state``). Raises on any input the kernel does not take and on a
    launch error."""
    n, m, B = A.shape
    floats = [("A", A), ("b", b), ("alpha1", a1), ("alpha2", a2), ("betas", betas)]
    ints, ins = [], (None,) * 9
    if state0 is not None:
        X0, Y0, t0, ps0, tv0, k0, d0, it0, g0 = state0
        d0 = d0.to(torch.int32)  # the kernel reads the done row as int32
        ins = (X0, Y0, t0, ps0, tv0, k0, d0, it0, g0)
        floats += zip(("X0", "Y0", "t0", "ps0", "tau0", "gap0"),
                      (X0, Y0, t0, ps0, tv0, g0))
        ints = list(zip(("k0", "done0", "iters0"), (k0, d0, it0)))
    _build.check_tensors(floats, ints)
    if b.shape != (m, B) or a1.shape != (B,) or a2.shape != (B,):
        raise ValueError(f"shapes do not match A {tuple(A.shape)}: b "
                         f"{tuple(b.shape)}, alpha {tuple(a1.shape)}")
    if state0 is not None and (X0.shape != (n, B) or Y0.shape != (n, B)
                               or any(v.numel() != B for v in ins[2:])):
        raise ValueError(f"the state's shapes do not match A {tuple(A.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the fused CUDA kernel is instantiated for "
                         f"n = 1..{MAX_N}, got n={n}")
    if b_tile % 32 or not 32 <= b_tile <= 256:
        raise ValueError(f"b_tile must be a multiple of 32 in 32..256, got {b_tile}")
    if betas.numel() < k_end + chunk:
        raise ValueError("the β table is shorter than k_end + chunk")
    if greedy is not None and armijo is not None:
        raise ValueError("the fused kernel has no greedy mode with Armijo")
    mode, restart, S, shrink, C, eta, max_bt = _build.mode_args(
        restart_threshold, greedy, armijo)
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=A.device)
    i32 = lambda: torch.empty((B,), dtype=torch.int32, device=A.device)
    X, iters, gap, done = f(n, B), i32(), f(B), i32()
    out = (f(n, B), f(B), f(B), f(B), i32()) if with_state else (None,) * 5
    _build.call(
        "fused_lasso_solve", A.device, A, b, a1, a2, betas, *ins, X, iters, gap,
        done, *out, n, m, B, b_tile, pl_iters, l_safety, t_init, chunk, k_end,
        tol, mode, int(armijo is not None), restart, S, shrink, C, eta, max_bt)
    Y, t, ps, tv, k = out
    return X, Y, t, ps, tv, k, done, iters, gap


def _plan(A, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile) -> dict:
    """Per-lane α vectors, the β table and the static launch parameters,
    shared by the kernel and its twin."""
    if A.dim() != 3:
        raise ValueError("A must be (n, m, B)")
    n, m, B = A.shape
    auto_bt, _ = auto_tiles_fused(n, m)
    a1, a2 = _lane_vector(alpha1, B, A), _lane_vector(alpha2, B, A)
    plan = _solve_plan(cfg, A.device)
    return dict(
        a1=a1, a2=a2, betas=plan.betas,
        # a tile never spans more than the batch, rounded as the reference rounds
        b_tile=min(auto_bt if b_tile is None else b_tile, _round_up(B, 128)),
        pl_iters=(32 if n <= 7 else 96) if pl_iters is None else pl_iters,
        l_safety=l_safety, **plan.static(),
    )


def _solve(run, A, b, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile,
           state0, return_state):
    """The plan, the state's layout and the result around one run (the
    kernel's or the twin's)."""
    with span("fos.plan"):
        plan = _plan(A, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile)
        rows = None
        if state0 is not None:
            if not isinstance(state0, FusedSolveState):
                raise TypeError(f"state0 must be a FusedSolveState, got "
                                f"{type(state0).__name__} (convert."
                                "fused_state_from_numpy takes the reference's)")
            rows = _state_rows(state0, A.shape[2], A.device, A.dtype)
            # k is read once per lane tile: a checkpoint cut under another
            # grouping would resume a whole tile from its first lane's k
            assert_tile_k_uniform(rows[5], A.shape[2], plan["b_tile"])
    out = run(A, b, state0=rows, with_state=return_state, **plan)
    with span("fos.result"):
        return _certified_result(out, cfg.rel_gap_tol,
                                 FusedSolveState if return_state else None)


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
    state0: FusedSolveState | None = None,
    return_state: bool = False,
):
    """The plain PyTorch twin of the fused kernel on a tensor of any device:
    the same ``BatchResult`` (and state) for the same inputs and lane
    grouping ``b_tile``. Certified lanes keep iterating until their tile
    exits, so a different ``b_tile`` gives a different ``x``."""
    _check_fused_cfg(cfg)
    return _solve(_plain_run, A, b, alpha1, alpha2, cfg, pl_iters, l_safety,
                  b_tile, state0, return_state)


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
    state0: FusedSolveState | None = None,
    return_state: bool = False,
):
    """Certified batched lasso, raw ``(A, b, α)`` to solutions: one kernel
    launch on a CUDA tensor, the plain twin on a CPU tensor. Every in-kernel
    mode runs, Armijo included; ``check_every > 0`` is required.

    ``interpret=True`` asks for the plain twin, which is what a CPU tensor
    gets; with a CUDA tensor it raises. ``overlap`` selects nothing (one
    kernel serves both reference variants), but ``overlap=True`` refuses
    what the reference's overlap variant refuses. ``b_tile`` is the CTA size
    and the twin's lane grouping (default 128). The reference's TPU tiling
    knobs ``m_tile`` and ``split_k`` have no counterpart.

    ``return_state=True`` returns ``(result, FusedSolveState)``; ``state0``
    resumes such a state bit-exactly under the same ``b_tile`` (``max_iter``
    counts every iteration, the resumed ones included)."""
    _check_fused_cfg(cfg, overlap=bool(overlap))
    if (state0 is not None or return_state) and overlap:
        raise NotImplementedError(
            "checkpoint/resume runs on the plain single-launch kernel; "
            "the overlap variant's solver state lives in per-column "
            "scratch and cannot round-trip (pass overlap=False/None)"
        )
    _build.refuse_interpret(interpret, A.is_cuda)
    run = _launch if A.is_cuda else _plain_run
    return _solve(run, A, b, alpha1, alpha2, cfg, pl_iters, l_safety, b_tile,
                  state0, return_state)
