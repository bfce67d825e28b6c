"""The host's share of a call, in ms: the median call of the untraced window
less the median time the engines' own kernels ran inside a traced call (the
router and ``_plan``, the host burst loop and its syncs, and the small torch
operations between the kernels). The calls are timed without the profiler,
whose own cost a call would read as host work; the trace gives only the
kernels' time, which the profiler does not stretch."""
import statistics

# The port's hand-written kernels, by the names the profiler records.
ENGINE_KERNELS = ("fused_lasso_solve", "gram_pairs", "gram_power", "fista_burst",
                  "resident", "qstream")


def read(run):
    if run.trace is None or not run.trace.calls() or not run.call_ms:
        return None
    kernels = [run.trace.device_s(s, e, ENGINE_KERNELS) for s, e in run.trace.calls()]
    return statistics.median(run.call_ms) - 1e3 * statistics.median(kernels)
