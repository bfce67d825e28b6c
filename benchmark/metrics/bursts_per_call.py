"""Bursts of the host burst loop a call: the program's ``bursts`` counter
over its ``calls`` counter, both counted over the whole run. Every call of a
run sends the same batch, so the ratio is each call's count, exactly. The
counters are the program's (``utils.profiling.counters``), reached in the
process the run imported it into; a program without them gives nothing."""
import sys

PROFILING = "fastoptsolver_tpu_torch.utils.profiling"


def read(run):
    counters = getattr(sys.modules.get(PROFILING), "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("calls") or "bursts" not in c:
        return None
    return c["bursts"] / c["calls"]
