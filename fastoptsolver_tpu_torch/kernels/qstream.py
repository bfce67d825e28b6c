"""The Q-streaming engine past the resident window (port of
``fastoptsolver_tpu/kernels/qstream.py``).

One burst of ``n_steps`` FISTA iterations with Q read from device memory at
every step: on a CUDA tensor one launch of the hand-written Hopper kernel
``csrc/qstream.cu`` (see its note for the design and the bound), on a CPU
tensor the plain twin :func:`_qstream_burst_reference`. Fixed, restart and
greedy momentum run; Armijo is refused, as in the reference (each trial
round would be one more pass over Q). ``fista_vmem._solve_on_device`` drives
the bursts with the same certification record as the burst engine, so
resume, early exit and the non-finite quarantine behave alike.

:func:`auto_tiles_qstream` returns the reference's plan (its VMEM window and
plane groups), so that ``fista_vmem.plan_gram_solve`` picks the same engine
in both packages; the CUDA kernel tiles lanes itself (32 lanes per CTA, 16
past n = 868), and no lane's result depends on the tiling.
"""
from __future__ import annotations

import torch

from . import _build
from .fista_vmem import SUBLANE, _burst_reference

# The kernel's feature window: the reference's qstream plan holds to n_pad = 1016.
MAX_N = 1016
# Launches of the CUDA kernel by this process (one per burst); incremented
# only where it launches.
LAUNCHES = 0


def auto_tiles_qstream(n_pad: int, vmem_budget_bytes: int = 10 * 1024 * 1024):
    """The reference's ``(b_tile, g_planes)``: the widest multiple-of-8
    plane group dividing n_pad whose double-buffered window and the ~4 state
    planes fit its TPU budget, at 256 lanes, else 128. Raises when none fits
    (past n_pad = 1016), as the reference raises."""
    for bt in (256, 128):
        state = (4 * n_pad + 4 * SUBLANE) * bt * 4
        gmax = (vmem_budget_bytes - state) // (2 * n_pad * bt * 4)
        if gmax < SUBLANE:
            continue
        for cand in range(min((gmax // SUBLANE) * SUBLANE, n_pad), 0, -SUBLANE):
            if n_pad % cand == 0:
                return bt, cand
    raise ValueError(
        f"qstream kernel: n_pad={n_pad} is past the engine's window "
        f"(n <= {MAX_N}); use the torch driver "
        "(batch.fista_gram.fista_gram_batch)"
    )


def _refuse_armijo(armijo) -> None:
    if armijo is not None:
        raise NotImplementedError(
            "armijo backtracking needs a data-dependent number of Q streams "
            "per iteration; past the resident window it runs on the torch "
            "driver (batch.fista_gram.fista_gram_batch)"
        )


def _qstream_burst_reference(betas, k0, Q, c, tau, thr, a2, a1, btb, X, Y, t,
                             ps, taumin=None, tauv=None, *, n_steps,
                             with_gap=False, restart_threshold=None,
                             greedy=None, armijo=None):
    """The plain twin of one burst: the burst engine's twin, whose plane
    loop is the same matvec the kernel streams; Armijo refused. Returns
    ``(X, Y, t, ps, tauv, gap)``."""
    _refuse_armijo(armijo)
    return _burst_reference(betas, k0, Q, c, tau, thr, a2, a1, btb, X, Y, t,
                            ps, taumin, tauv, n_steps=n_steps,
                            with_gap=with_gap,
                            restart_threshold=restart_threshold, greedy=greedy)


def _launch_qstream(betas, k0, Q, c, tau, thr, a2, a1, btb, X, Y, t, ps,
                    taumin=None, tauv=None, *, n_steps, with_gap=False,
                    restart_threshold=None, greedy=None, armijo=None):
    """Launch ``qstream_burst`` on the current stream; the same outputs as
    :func:`_qstream_burst_reference` (``tauv`` passes through). Raises on
    any input the kernel does not take and on a launch error."""
    global LAUNCHES
    _refuse_armijo(armijo)
    n, B = c.shape
    rows = (("tau", tau), ("thr", thr), ("a2", a2), ("a1", a1), ("btb", btb),
            ("t", t), ("ps", ps))
    if greedy is not None:
        rows += (("taumin", taumin),)
    for name, v in (("Q", Q), ("c", c), ("X", X), ("Y", Y), ("betas", betas)) + rows:
        if (not isinstance(v, torch.Tensor) or not v.is_cuda
                or v.dtype != torch.float32 or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if v.device != Q.device:
            raise ValueError(f"{name} is on {v.device}, Q on {Q.device}")
    if Q.shape != (n, n, B) or X.shape != (n, B) or Y.shape != (n, B):
        raise ValueError(f"shapes do not match: Q {tuple(Q.shape)}, c {(n, B)}, "
                         f"X {tuple(X.shape)}, Y {tuple(Y.shape)}")
    for name, v in rows:
        if v.numel() != B:
            raise ValueError(f"{name} must hold {B} lanes, got {tuple(v.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the qstream kernel takes n = 1..{MAX_N}, got n={n}")
    fixed = greedy is None and restart_threshold is None
    if fixed and betas.numel() < k0 + n_steps:
        raise ValueError("the β table is shorter than k0 + n_steps")
    mode = 2 if greedy is not None else (0 if fixed else 1)
    S, shrink = greedy if greedy is not None else (0.0, 0.0)
    lib = _build.library()
    Xo, Yo = torch.empty_like(X), torch.empty_like(Y)
    to, pso, gap = (torch.empty_like(tau) for _ in range(3))
    ptr = lambda v: None if v is None else v.data_ptr()
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    with torch.cuda.device(Q.device):
        err = lib.qstream_burst(
            *(ptr(v) for v in (Q, c, tau, thr, a2, a1, btb, X, Y, t, ps,
                               taumin if greedy is not None else None, betas,
                               Xo, Yo, to, pso, gap)),
            n, B, n_steps, k0, mode, int(with_gap),
            float(restart_threshold or 0.0), S, shrink, stream,
        )
    _build.check(err, "qstream_burst")
    LAUNCHES += 1
    return Xo, Yo, to, pso, tauv, gap


def qstream_burst(*args, **kw):
    """One burst: the CUDA kernel on a CUDA tensor, the plain twin on a CPU
    tensor (``args[2]`` is Q)."""
    return (_launch_qstream if args[2].is_cuda else _qstream_burst_reference)(
        *args, **kw)
