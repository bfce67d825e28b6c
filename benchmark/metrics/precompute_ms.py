"""The torch Gram precompute's time a call, in ms: the program's span
``fos.gram_precompute`` (the einsums that make Q, c and bᵀb, then the eager
power iteration for L, up to its last read), summed over each call; the
median over the calls the profiler recorded, the harness's first traced
call (``bench.warm``) left out.

Read under the profiler, which adds its own cost to every host operator and
span; the stage waits for the card at each power step, so the reading is
mostly the card's time. The spans are the program's record
(``utils.profiling.spans``), reached in the process the run imported it
into; a program without that record, or a call that takes another build,
gives nothing."""
import statistics
import sys
from collections import defaultdict

PROFILING = "fastoptsolver_tpu_torch.utils.profiling"
ROOT, STAGE = "fos.solve_lasso_batch", "fos.gram_precompute"


def read(run):
    spans = getattr(sys.modules.get(PROFILING), "spans", None)
    if run.trace is None or spans is None:
        return None
    roots, stage = set(), defaultdict(int)
    for call, name, parent, start, end in spans():
        if end is None:
            continue
        if name == ROOT and parent is None:
            roots.add(call)
        elif name == STAGE:
            stage[call] += end - start
    calls = [c for c in sorted(roots)[1:] if c in stage]  # the first is bench.warm
    if not calls:
        return None
    return 1e-6 * statistics.median(stage[c] for c in calls)
