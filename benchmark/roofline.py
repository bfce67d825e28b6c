"""A kernel's share of its roofline: the least time the card could take for
the work, over the time the kernel took.

The least time is the larger of the operations over the card's float32 peak
and the bytes over its memory rate, NVIDIA's published figures in
``peaks.json`` for the card the run names. Each metric reader counts the
operations and bytes its stage needs from the shapes and from the
iterations every lane ran, never from how a kernel happens to move them.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str):
    """The published peaks of the card named ``kind``, or None."""
    with open(PEAKS) as f:
        return json.load(f).get(kind)


def bound_s(nbytes: float, flops: float, peak: dict) -> float:
    """The least seconds the card could take for ``nbytes`` and ``flops``."""
    return max(nbytes / peak["bytes_per_s"], flops / peak["f32_flop_per_s"])


def solve_flops(n: int, iters, check_every: int) -> float:
    """A certified solve's operations on an n×n Gram: each lane's own
    iterations and gap checks, one Gram matvec (2n² operations) each."""
    it = iters.sum().item()
    checks = ((iters + check_every - 1) // check_every).sum().item()
    return 2.0 * n * n * (it + checks)


def pair_flops(n: int, m: int, B: int) -> float:
    """The augmented Gram's distinct pair sums over m rows: Q's upper
    triangle, c and bᵀb, one multiply-add (2 operations) a pair and row."""
    return 2.0 * (n + 1) * (n + 2) / 2 * m * B


def estimate_flops(n: int, B: int) -> float:
    """The Lipschitz estimate L = λ_max(Q) of each lane, counted as one Gram
    matvec (2n² operations): the least any estimate from Q takes, since it
    reads every entry of Q once. The further steps an iterative estimate
    takes are the program's choice, so a share does not credit them, and a
    program that estimates L with fewer of them is held to the same count."""
    return 2.0 * n * n * B


def share_pct(run, kernels, count) -> float | None:
    """``100 ×`` the bound of ``count(work)`` (bytes, operations) over the
    mean time a traced call spent in device operations named by
    ``kernels``; None where the run was not traced, the card has no entry in
    ``peaks.json`` or no such kernel ran."""
    if run.trace is None or run.work is None or run.peaks is None:
        return None
    calls = run.trace.calls()
    spent = sum(run.trace.device_s(s, e, kernels) for s, e in calls) / max(len(calls), 1)
    if spent <= 0.0:
        return None
    nbytes, flops = count(run.work)
    return 100.0 * bound_s(nbytes, flops, run.peaks) / spent
