"""Seconds from the process's start to the first timed call: imports, the
kernel library's load (its build in a fresh checkout), the batch made on
the card and one warm call of the cell's own shape."""


def read(run):
    return None if run.trace is not None else run.setup_s
