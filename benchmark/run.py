"""One run of one cell of the benchmark of ``fastoptsolver_tpu_torch``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The run makes the cell's batch on the card from the seed, warms the
call up once, then calls it back to back, one caller waiting for each
result, until the first call that ends after ``--seconds``. With
``--trace 1`` a stretch of at most ``TRACE_SECONDS`` more calls runs under
the profiler after that window, and the run reports the per-layer metrics,
read from the two together. Once the window has
closed the answers of the kept calls are judged against the plain
reference. The last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``) and, last, ``check``: each number compared beside its limit,
which also end standard error. Without a CUDA device, with fewer devices
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, the run prints no result and exits non-zero.
"""
import time

_T0 = time.monotonic()  # before torch and the program are imported

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fastoptsolver_tpu")
TRACE_SECONDS = 2.0  # the longest stretch a traced run records
KEEP = 6  # calls kept for the check besides the first and the last


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().replace("\n", "; ") if out.returncode == 0 else "unknown"


class _Clock:
    """Times one call to the point where its result is readable: CUDA events
    on the card's stream, synchronised (the card's own clock), or the host's
    clock on the CPU."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.stop = torch.cuda.Event(enable_timing=True)

    def time(self, fn):
        """``(ms, fn())``."""
        if self.cuda:
            self.start.record()
            out = fn()
            self.stop.record()
            self.stop.synchronize()
            return self.start.elapsed_time(self.stop), out
        t = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t), out


def _untraced(name):
    return contextlib.nullcontext()


def _window(session, clock, seconds: float, moments: list, span=_untraced):
    """Call back to back until the first call that ends after ``seconds``;
    keep the first call, the last, and the first to end after each of
    ``moments``. ``(call ms, seconds measured, the last call's result)``."""
    call_ms = []
    w0 = time.perf_counter()
    while True:
        with span("bench.call"):
            ms, res = clock.time(session.call)
        with span("bench.count"):
            session.account(res)
        call_ms.append(ms)
        elapsed = time.perf_counter() - w0
        last = elapsed >= seconds
        if len(call_ms) == 1 or last or (moments and elapsed >= moments[0]):
            session.keep(res)
            while moments and elapsed >= moments[0]:
                moments.pop(0)
        if last:
            return call_ms, elapsed, res


def _spread(call_ms) -> str:
    """The calls' quantiles, and the stalls: calls over twice the median and
    the time they took beyond it."""
    ms = sorted(call_ms)
    med = ms[len(ms) // 2]
    quart = " ".join(f"{ms[int(q * (len(ms) - 1))]:.4f}" for q in (0, .05, .25, .5, .75, .95, .99, 1))
    stalls = [t - med for t in ms if t > 2 * med]
    return (f"call ms at 0 5 25 50 75 95 99 100%: {quart}; stalls {len(stalls)}, "
            f"{sum(stalls):.3f} ms past the median")


def _idle_pct(trace_obj) -> str:
    if trace_obj.window() is None:
        return "none"
    lo, hi = trace_obj.window()
    return f"{100.0 * (1.0 - trace_obj.busy_s(lo, hi) / (hi - lo)):.4f}%"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, lanes=None,
             t0: float = _T0):
    """Run ``cell`` once: ``(result line, check lines)``."""
    import torch

    from benchmark import roofline, spec
    from benchmark import trace as tr

    t_start = time.monotonic()
    session = spec.driver(cell.config).Session(cell, seed, device, lanes)
    clock = _Clock(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_data = time.monotonic()
    clock.time(session.call)  # warm: the library, the plan, the shapes
    t_warm = time.monotonic()
    # what imports left on the heap never moves again: keep the collector
    # from walking it inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t0
    notes = [f"setup {setup_s:.3f} s: to the harness {t_start - t0:.3f}, data "
             f"{t_data - t_start:.3f}, warm call {t_warm - t_data:.3f}, "
             f"heap frozen {t0 + setup_s - t_warm:.3f}"]
    # the calls kept for the check: the first, the last, and the first call
    # to end after each of KEEP moments drawn from the seed
    moments = sorted((torch.rand(KEEP, generator=torch.Generator().manual_seed(seed))
                      * seconds).tolist())
    call_ms, elapsed, res = _window(session, clock, seconds, moments)
    totals = session.totals()
    trace_obj = traced_ms = None
    if trace:
        # a stretch of calls under the profiler after the window, which
        # stays untraced: the profiler's own cost a call (it records every
        # host operator) stays out of the times the metrics divide by
        prof = tr.profiler()
        prof.start()
        with tr.span("bench.warm"):
            clock.time(session.call)
        traced_ms, _, res = _window(session, clock, TRACE_SECONDS, [], tr.span)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        out_dir = Path(tempfile.gettempdir()) / "benchmark-traces"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{cell.name}-{seed}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        trace_obj = tr.Trace.from_file(path)
        notes.append(f"trace: {path}")
    gc.unfreeze()
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    run = SimpleNamespace(window_s=elapsed, call_ms=call_ms, setup_s=setup_s, totals=totals,
                          trace=trace_obj, work=session.work(res), peaks=roofline.peaks(kind))
    del res
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": None, "attempted": len(call_ms) * session.lanes,
            "failed": totals["failed"], "metrics": metrics, "device": dev}
    if trace_obj is not None and trace_obj.window() is not None:
        lo, hi = trace_obj.window()
        dev["busy_s"] = trace_obj.busy_s(lo, hi)
        dev["window_s"] = hi - lo
        line["breakdown"] = {"device_ops": trace_obj.top_ops(lo, hi),
                             "idle_gaps": trace_obj.idle_gaps(lo, hi)}
    notes.append(f"calls {len(call_ms)} in {elapsed:.3f} s; {_spread(call_ms)}; {totals}")
    if trace_obj is not None:
        notes.append(f"traced calls {len(traced_ms)}: {_spread(traced_ms)}; the traced "
                     f"stretch's device idle share {_idle_pct(trace_obj)}")
    numbers = session.readings()
    notes.append("readings " + json.dumps(numbers))
    correct, held = session.judge(numbers)
    line["correct"] = correct
    line["check"] = held
    lines = notes + [f"check {k} {v['value']:.6g} limit {v['limit']:.6g} "
                     f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}" for k, v in held.items()]
    return line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is visible; nothing was measured", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    t_torch = time.monotonic()
    import fastoptsolver_tpu_torch as program

    if spec.ROOT not in Path(program.__file__).resolve().parents:
        print(f"benchmark: the program was imported from {program.__file__}, "
              f"outside this checkout ({spec.ROOT})", file=sys.stderr)
        return 2
    t_program = time.monotonic()
    line, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}; imports: torch {t_torch - _T0:.3f} s, the program "
          f"{t_program - t_torch:.3f} s", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
