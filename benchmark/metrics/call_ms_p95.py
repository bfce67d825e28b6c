"""The 95th percentile of every call's time in the window, in ms. Each call
is timed on the card's own clock by CUDA events recorded on the stream at
the call's entry and after its last operation, then synchronised: a call
of well under a millisecond is below what the host clock resolves."""
import statistics


def read(run):
    if run.trace is not None or len(run.call_ms) < 20:
        return None
    return statistics.quantiles(run.call_ms, n=100, method="inclusive")[94]
