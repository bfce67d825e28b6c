"""The Q-streaming engine past the resident window (port of
``fastoptsolver_tpu/kernels/qstream.py``).

One burst of ``n_steps`` FISTA iterations: on a CUDA tensor one launch of
the hand-written Hopper kernels of ``csrc/qstream.cu`` (see its note for the
designs and the bounds), on a CPU tensor the plain twin
:func:`_qstream_burst_reference`. Fixed, restart and greedy momentum run;
Armijo is refused, as in the reference. ``fista_vmem._solve_on_device``
drives the bursts with the same certification record as the burst engine,
so resume, early exit and the non-finite quarantine behave alike.

Where :func:`cluster_size` gives C > 0 (n up to ~660) each lane runs on a
thread-block cluster of C CTAs that hold its Q in shared memory for the
whole launch, split by output feature, so device memory carries Q once a
launch instead of once a step. The kernel reads Q re-laid by
:func:`relayout` into one contiguous slab a CTA. :func:`make_burst` makes
that copy once a solve, at the first burst, and reuses it for every launch:
one more tensor of Q's size (plus padding) for the solve's length, 1.98 GB
at n = 256, B = 7552. Past that window the streaming kernel reads Q from
device memory every step. Both give the same bits.

:func:`auto_tiles_qstream` returns the reference's plan (its VMEM window and
plane groups), so that ``fista_vmem.plan_gram_solve`` picks the same engine
in both packages; no lane's result depends on the CUDA kernels' tiling.
"""
from __future__ import annotations

import torch

from ..utils.profiling import count, launch, span
from . import _build
from .fista_vmem import SUBLANE, _burst_args, _burst_reference

# The kernel's feature window: the reference's qstream plan holds to n_pad = 1016.
MAX_N = 1016


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


def slab_features(n: int, C: int) -> int:
    """F: the output features a CTA of a C-CTA cluster holds, ceil(n / C)
    rounded up to a multiple of 4 (``csrc/qstream.cu:slab_features``)."""
    return (-(-n // C) + 3) // 4 * 4


def relayout(Q: torch.Tensor, C: int) -> torch.Tensor:
    """Q ``(n, n, B)`` re-laid for clusters of ``C`` CTAs: ``Qt[l, r, k, j]
    = Q[k, r·F + j, l]`` (F = :func:`slab_features`), zero where ``r·F + j
    ≥ n``, shape ``(B, C, n, F)``, contiguous; so the slab of CTA r of lane
    l is one block of n·F floats. A zeros tensor and one permuted copy a
    rank, on Q's device; the span ``fos.relayout`` under a profiler, and
    one in the ``qstream_relayouts`` counter."""
    with span("fos.relayout"):
        n, _, B = Q.shape
        F = slab_features(n, C)
        Qt = torch.zeros((B, C, n, F), dtype=Q.dtype, device=Q.device)
        for r in range(C):
            w = min(F, n - r * F)
            if w > 0:
                Qt[:, r, :, :w].copy_(Q[:, r * F:r * F + w, :].permute(2, 0, 1))
    count("qstream_relayouts")
    return Qt


def cluster_size(n: int) -> int:
    """The cluster kernel's size at width ``n`` (``qstream_cluster_size`` in
    C): 1, 2, 4 or 8 CTAs a lane, or 0 where the streaming kernel serves."""
    return _build.library().qstream_cluster_size(n)


@launch("qstream")
def _launch_qstream(betas, k0, Q, c, tau, thr, a2, a1, btb, X, Y, t, ps,
                    taumin=None, tauv=None, *, n_steps, with_gap=False,
                    restart_threshold=None, greedy=None, armijo=None, Qt=None,
                    cluster=None):
    """Launch ``qstream_burst`` on the current stream; the same outputs as
    :func:`_qstream_burst_reference` (``tauv`` passes through). Raises on
    any input the kernel does not take and on a launch error.

    ``cluster`` is :func:`cluster_size` unless given (tests and timings
    force a size; 0 is the streaming kernel). The cluster kernel reads
    ``Qt``, :func:`relayout` of Q at that size, made here when not passed."""
    _refuse_armijo(armijo)
    rows = (("tau", tau), ("thr", thr), ("a2", a2), ("a1", a1), ("btb", btb),
            ("t", t), ("ps", ps))
    mode, restart, S, shrink, *_ = _burst_args(
        "qstream", MAX_N, betas, k0, Q, c, X, Y, rows, taumin, (), n_steps=n_steps,
        restart_threshold=restart_threshold, greedy=greedy, armijo=None)
    n, B = c.shape
    if cluster is None:
        cluster = cluster_size(n)
    if cluster == 0:
        Qt = None
    else:
        if Qt is None:
            Qt = relayout(Q, cluster)
        want = (B, cluster, n, slab_features(n, cluster))
        if (Qt.shape != want or Qt.device != Q.device or Qt.dtype != torch.float32
                or not Qt.is_contiguous()):
            raise ValueError(f"Qt must be a contiguous float32 tensor of shape {want} "
                             f"on {Q.device}, got {tuple(Qt.shape)} on {Qt.device}")
    Xo, Yo = torch.empty_like(X), torch.empty_like(Y)
    to, pso, gap = (torch.empty_like(tau) for _ in range(3))
    _build.call(
        "qstream_burst", Q.device, Q, Qt, c, tau, thr, a2, a1, btb, X, Y, t, ps,
        taumin if greedy is not None else None, betas, Xo, Yo, to, pso, gap,
        n, B, n_steps, k0, mode, int(with_gap), cluster, restart, S, shrink)
    return Xo, Yo, to, pso, tauv, gap


def qstream_burst(*args, **kw):
    """One burst: the CUDA kernel on a CUDA tensor, the plain twin on a CPU
    tensor (``args[2]`` is Q)."""
    return (_launch_qstream if args[2].is_cuda else _qstream_burst_reference)(
        *args, **kw)


def make_burst(Q: torch.Tensor):
    """:func:`qstream_burst` for the bursts of one solve on ``Q``: on a CUDA
    tensor in the cluster window, a closure that re-lays Q at its first
    call and passes that copy to every launch; otherwise
    :func:`qstream_burst` itself (the streaming kernel, or the twin on a
    CPU tensor, which keeps Q as it is)."""
    C = cluster_size(Q.shape[0]) if Q.is_cuda else 0
    if C == 0:
        return qstream_burst
    held = []

    def burst(*args, **kw):
        if not held:
            held.append(relayout(args[2], C))
        return _launch_qstream(*args, Qt=held[0], cluster=C, **kw)

    return burst
