"""Lanes certified a second: lanes the calls returned with ``converged``
true, summed over every call in the window, over the window's seconds on
the host clock (the window spans many calls and at least ``--seconds``)."""


def read(run):
    if run.trace is not None or not run.window_s:
        return None
    return run.totals["certified"] / run.window_s
