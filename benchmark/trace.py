"""The benchmark's spans and the device trace of a traced run.

The harness opens ``bench.*`` spans (``torch.profiler.record_function``)
around its own steps: ``bench.call`` around each timed call, up to the
synchronisation that makes its result readable, and ``bench.count`` around
the per-call counters. ``torch.profiler`` records them with every device
operation (kernels, copies, fills) and every host operator; the exported
Chrome trace is read back here into intervals in seconds.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
CALL = "bench.call"


def profiler():
    """A ``torch.profiler.profile`` over the host and, where there is one,
    the card; the caller starts and stops it."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


def _union(intervals):
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _index(ivs):
    """Start times and the running furthest end of a sorted interval list."""
    reach, far = [], float("-inf")
    for _, e, _ in ivs:
        far = max(far, e)
        reach.append(far)
    return [s for s, _, _ in ivs], reach


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Trace:
    """Device operations, the benchmark's spans and host operators, each a
    list of ``(start_s, end_s, name)``."""

    def __init__(self, events: list[dict]):
        def pick(cats):
            return sorted((ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0.0)) * 1e-6, ev["name"])
                          for ev in events
                          if ev.get("ph") == "X" and ev.get("cat") in cats)

        self.device = pick(DEVICE_CATS)
        self.spans = [s for s in pick(("user_annotation",)) if s[2].startswith("bench.")]
        self.host = pick(HOST_CATS)
        self._span_index = _index(self.spans)
        self._host_index = _index(self.host)

    @classmethod
    def from_file(cls, path: Path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def calls(self):
        """``(start, end)`` of every ``bench.call`` span."""
        return [(s, e) for s, e, name in self.spans if name == CALL]

    def window(self):
        """From the first call's start to the last call's end."""
        calls = self.calls()
        return (calls[0][0], calls[-1][1]) if calls else None

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` in which some device operation runs."""
        return sum(e - s for s, e in _union(_clip([(s, e) for s, e, _ in self.device], lo, hi)))

    def device_s(self, lo: float, hi: float, names) -> float:
        """Seconds of ``[lo, hi]`` covered by device operations whose name
        holds one of ``names``."""
        spans = [(s, e) for s, e, name in self.device if any(k in name for k in names)]
        return sum(e - s for s, e in _union(_clip(spans, lo, hi)))

    def top_ops(self, lo: float, hi: float, k: int = 10):
        """The ``k`` device operations with the most time in ``[lo, hi]``."""
        total = defaultdict(float)
        for s, e, name in self.device:
            if e > lo and s < hi:
                total[name] += min(e, hi) - max(s, lo)
        return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:k]

    def _host_at(self, t: float) -> str:
        """The benchmark span and the innermost host operator running at ``t``
        (``python`` where the host ran no operator the profiler records)."""
        def innermost(ivs, starts, reach):
            # the latest-starting interval that still covers t; reach[i] is
            # the furthest end of intervals 0..i, so the walk stops early
            i = bisect.bisect_right(starts, t)
            while i > 0 and reach[i - 1] > t:
                i -= 1
                if ivs[i][1] > t:
                    return ivs[i][2]
            return None

        where = innermost(self.spans, *self._span_index) or "between spans"
        op = innermost(self.host, *self._host_index)
        return f"{where} / {op or 'python'}"

    def idle_gaps(self, lo: float, hi: float, k: int = 10):
        """Idle time of ``[lo, hi]`` by what the host was doing halfway
        through each gap: the ``k`` names with the most idle seconds."""
        busy = _union(_clip([(s, e) for s, e, _ in self.device], lo, hi))
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        total = defaultdict(float)
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                total[self._host_at(0.5 * (s + e))] += e - s
        return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:k]
