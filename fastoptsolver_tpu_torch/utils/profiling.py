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
  reference's ``get_metrics`` numbers;
- :func:`span`, :func:`spans` — the program's own spans at its layer
  boundaries (the router, the plan, the Gram build and the torch
  precompute's stages, each kernel launch, Q's re-layout, the burst loop,
  the result) and where the host waits for the card (``fos.sync``),
  recorded only while a ``torch.profiler`` records, on the profiler's
  timeline and in memory;
- :func:`counters`, :func:`reset_counters` — the program's counters, always
  on: calls, kernel launches, bursts and the lanes they carry, the power
  steps of the eager L estimate, Q's re-layouts.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
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


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

# The most spans one profiler session keeps; past it they are counted in
# ``spans_dropped``.
SPAN_LIMIT = 1 << 16

# Every counter, in the order ``counters()`` lists them. ``launches.<kernel>``
# counts the launches of one hand-written kernel that returned without error
# (``fused``: fused_lasso_solve; ``gram_pairs``, ``gram_power``: the Gram
# build; ``burst``: fista_burst; ``resident``; ``qstream``; ``stream``: the
# read-ceiling pass; ``lipschitz``: the torch precompute's power steps).
COUNTERS = (
    "calls",  # solve_lasso_batch calls
    "launches.fused", "launches.gram_pairs", "launches.gram_power",
    "launches.burst", "launches.resident", "launches.qstream", "launches.stream",
    "launches.lipschitz",
    "bursts",  # bursts of the host burst loop, kernels and twins alike
    # the lanes of each burst whose start reads the live count (the
    # early-exit loop), and of those the lanes not yet certified
    "burst_lanes", "burst_lanes_live",
    # burst launches that store the solve's Grams to its slab (its first
    # burst, when a later one follows) and that read them from it
    "burst_slab_writes", "burst_slab_reads",
    # burst launches at a width where an SM holds two or more of the kernel's
    # CTAs (fista_burst_ctas_per_sm), so one CTA's copy-in runs under another's steps
    "burst_paired_launches",
    "power_steps",  # power steps of make_gram_batch's Lipschitz estimate, up to its stop
    "qstream_relayouts",  # copies of Q into the Q-streaming cluster layout
    "spans_dropped",  # spans past SPAN_LIMIT in one profiler session
)
_counts = dict.fromkeys(COUNTERS, 0)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :data:`COUNTERS`)."""
    _counts[name] += n


def counters() -> dict:
    """Every counter's value since the process started or
    :func:`reset_counters` last ran."""
    return dict(_counts)


def reset_counters() -> None:
    """Set every counter to 0."""
    for name in _counts:
        _counts[name] = 0


class _Off:
    """The span while no profiler records: entering and leaving it does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
# The spans of the current profiler session, ``[call, name, parent, start_ns,
# end_ns]`` each; ``parent`` is the index of the enclosing span in this list.
_record: list = []
_calls = 0  # the last call id handed out
_open = threading.local()  # each thread's stack of open spans' indices


class _Span:
    """A span while a profiler records: a ``record_function`` range on the
    profiler's timeline, and a row of :data:`_record` stamped with
    ``time.time_ns()``, the Unix clock to which the profiler converts its
    own stamps: the start at the midpoint of the range's opening, the end
    once the range has closed."""

    __slots__ = ("_name", "_range", "_row")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        global _calls
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if not stack:
            _calls += 1
        parent = stack[-1] if stack else None
        self._range = torch.profiler.record_function(self._name)
        before = time.time_ns()
        self._range.__enter__()
        # the range's own stamp falls inside its opening, which takes from a
        # few µs to a few hundred (cold): its midpoint stands for it
        start = (before + time.time_ns()) // 2
        self._row = row = [_calls, self._name, parent, start, None]
        index = len(_record)
        if index < SPAN_LIMIT:
            _record.append(row)
        else:
            _counts["spans_dropped"] += 1
        stack.append(index)
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _open.stack.pop()
        self._row[4] = time.time_ns()
        return False


def span(name: str):
    """``with span("fos.plan"): ...`` — a span of the program. While no
    ``torch.profiler`` records, the shared no-op: one flag is read, and no
    clock, range or object is made. While one records, a
    ``record_function`` range (so every profiler trace, ``trace``'s
    included, shows it beside the kernels) kept in memory for
    :func:`spans`. A span opened with none open starts a new call id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans() -> list:
    """The spans recorded since a profiler last started (at most
    :data:`SPAN_LIMIT`): ``(call id, name, parent, start_ns, end_ns)`` each,
    in the order they opened; ``parent`` is the index of the enclosing span
    in this list (None for a call's root), ``end_ns`` None while it is open.
    ``start_ns`` less the exported trace's ``baseTimeNanoseconds`` is the
    range's ``ts`` there, in ns."""
    return [tuple(row) for row in _record]


def launch(kernel: str):
    """Decorate the function that launches ``kernel``: a
    ``fos.launch.<kernel>`` span around it (the checks, the allocations and
    the library call) and ``launches.<kernel>`` counted when it returns."""
    name, key = f"fos.launch.{kernel}", f"launches.{kernel}"
    if key not in _counts:
        raise ValueError(f"no counter {key!r}; the counters are {COUNTERS}")

    def wrap(fn):
        @functools.wraps(fn)
        def launched(*args, **kw):
            with span(name):
                out = fn(*args, **kw)
            _counts[key] += 1
            return out

        return launched

    return wrap


def _reset_on_profiler_start() -> None:
    """Clear the span record whenever a profiler starts: every profiler
    (``torch.profiler.profile``, the legacy and the ITT/NVTX ones) calls
    ``torch.autograd.profiler._run_on_profiler_start`` as it starts."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "clears_program_spans", False):
        return

    @functools.wraps(start)
    def run_on_profiler_start(*args, **kw):
        _record.clear()
        return start(*args, **kw)

    run_on_profiler_start.clears_program_spans = True
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


_reset_on_profiler_start()
