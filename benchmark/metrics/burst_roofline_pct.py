"""The burst engine's share of its roofline, in %: the certified solve on a
given Gram, every ``fista_burst`` launch of the call summed.

Bytes: Q and c read once; x, iters, gap and done written once. Operations:
each lane's own iterations and gap checks, one Gram matvec (2n²) each, not
the bursts the lanes run in lockstep."""
from benchmark import roofline

KERNELS = ("fista_burst",)


def count(work):
    n, B = work["n"], work["B"]
    nbytes = 4.0 * ((n * n + n) * B + (n + 3) * B)
    return nbytes, roofline.solve_flops(n, work["iters"], work["check_every"])


def read(run):
    return roofline.share_pct(run, KERNELS, count)
