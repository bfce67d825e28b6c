"""The burst engine's useful share of its lane-bursts, in %: lanes not yet
certified as each burst starts (the program's ``burst_lanes_live``
counter) over the lanes the bursts carry (``burst_lanes``), over the whole
run. A certified lane keeps iterating until the loop exits, so the rest is
work whose result is already decided. The counters are the program's
(``utils.profiling.counters``), reached in the process the run imported it
into; a program without them gives nothing."""
import sys

PROFILING = "fastoptsolver_tpu_torch.utils.profiling"


def read(run):
    counters = getattr(sys.modules.get(PROFILING), "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("burst_lanes"):
        return None
    return 100.0 * c["burst_lanes_live"] / c["burst_lanes"]
