"""The resident engine's useful share of its lane-steps, in %: the steps each
lane ran before its own certificate (the program's
``resident_lane_steps_live`` counter) over the steps its group ran
(``resident_lane_steps``), over the whole run. A CTA holds a group of lanes
and iterates until every one of them is certified, so the rest is work
whose result is already decided. The counters are the program's
(``utils.profiling.counters``), reached in the process the run imported it
into; a program without them gives nothing."""
import sys

PROFILING = "fastoptsolver_tpu_torch.utils.profiling"


def read(run):
    counters = getattr(sys.modules.get(PROFILING), "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("resident_lane_steps"):
        return None
    return 100.0 * c["resident_lane_steps_live"] / c["resident_lane_steps"]
