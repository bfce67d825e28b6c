"""Profiling / observability utilities (port of
``fastoptsolver_tpu/utils/profiling.py``).

- :func:`trace` — a ``torch.profiler`` window (the CPU, and the card when
  there is one) written as a Chrome trace into ``log_dir``; the profiler is
  yielded, so ``key_averages()`` gives the device time by kernel;
- :func:`timed` — wall-clock timing that waits for the devices of every
  tensor in the output (the counterpart of ``block_until_ready``), warm-up
  calls excluded;
- :func:`solver_stats` — the per-solve counters of a ``SolveResult``'s
  ``Metrics`` (grad evaluations, line-search calls and backtracks), the
  reference's ``get_metrics`` numbers.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as _pytree


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("traces") as prof: solve(...)`` → a Chrome trace
    (``*.pt.trace.json``, for Perfetto or ``chrome://tracing``) in
    ``log_dir``; ``prof.key_averages()`` sums the window by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def _block(out):
    """Wait for every CUDA device that holds a tensor of ``out``."""
    devices = {leaf.device for leaf in _pytree.tree_leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def timed(fn: Callable[..., Any], *args, repeats: int = 3, warmup: int = 1):
    """Run ``fn(*args)`` with warm-up calls excluded; returns
    ``(last_output, stats_dict)`` with mean/min/max wall seconds."""
    out = None
    for _ in range(max(warmup, 0)):
        out = _block(fn(*args))
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, {
        "mean_s": float(np.mean(times)),
        "min_s": float(np.min(times)),
        "max_s": float(np.max(times)),
        "repeats": len(times),
    }


def solver_stats(result) -> dict:
    """Counters for a ``SolveResult`` (or a stacked batch of them): the
    reference's ``get_metrics`` (iterative_solvers.py:26-40)."""
    m = result.metrics

    def tot(x):
        return int(torch.as_tensor(x).sum())

    n_iters = tot(result.n_iters)
    return {
        "n_iters": n_iters,
        "grad_num_calls": tot(m.n_grad_evals),
        "ls_num_calls": tot(m.n_ls_calls),
        "ls_iters_total": tot(m.ls_iters_total),
        "backtracks_per_ls": (
            tot(m.ls_iters_total) / tot(m.n_ls_calls) if tot(m.n_ls_calls) else 0.0
        ),
    }
