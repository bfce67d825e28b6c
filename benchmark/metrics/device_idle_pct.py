"""Share of the untraced window in which no device operation (kernel, copy
or fill) runs, in %: the window's calls times the device's busy seconds a
traced call (the traced stretch's busy seconds over its calls), over the
window's seconds. The busy time comes from the
traced calls, which the profiler does not stretch on the device; the
window's length and its count of calls come from the untraced window, so
the profiler's own host cost a call does not read as idle time."""


def read(run):
    if run.trace is None or not run.trace.calls() or not run.window_s:
        return None
    busy = run.trace.busy_s(*run.trace.window()) / len(run.trace.calls())
    return 100.0 * (1.0 - len(run.call_ms) * busy / run.window_s)
