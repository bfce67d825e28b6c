"""The host's own time a call, in ms, from the program's spans: each call's
root span (``fos.solve_lasso_batch``) less the ``fos.sync`` spans inside it,
where the host waits for the card; the median over the calls the profiler
recorded, the harness's first traced call (``bench.warm``) left out.

Read under the profiler, which adds its own cost to every host operator and
span, so it reads above the untraced host time (``host_overhead_ms``) by
that cost: it follows the same layer from inside, where the spans split it.
The spans are the program's record (``utils.profiling.spans``), reached in
the process the run imported it into; a program without that record gives
nothing."""
import statistics
import sys
from collections import defaultdict

PROFILING = "fastoptsolver_tpu_torch.utils.profiling"
ROOT, WAIT = "fos.solve_lasso_batch", "fos.sync"


def read(run):
    spans = getattr(sys.modules.get(PROFILING), "spans", None)
    if run.trace is None or spans is None:
        return None
    roots, waits = {}, defaultdict(int)
    for call, name, parent, start, end in spans():
        if end is None:
            continue
        if name == ROOT and parent is None:
            roots[call] = end - start
        elif name == WAIT:
            waits[call] += end - start
    calls = sorted(roots)[1:]  # the first is the harness's bench.warm call
    if not calls:
        return None
    return 1e-6 * statistics.median(roots[c] - waits[c] for c in calls)
