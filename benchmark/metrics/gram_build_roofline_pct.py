"""The Gram build's share of its roofline, in %: the stage from raw A and b
to Q, c, bᵀb and L, both of its launches (``gram_pairs``, ``gram_power``).

Bytes: A and b read once; Q (n×n), c, bᵀb and L written once. Operations:
the augmented Gram's pair sums and the Lipschitz estimate as one Gram
matvec (``roofline.estimate_flops``), however many steps ``gram_power``
takes."""
from benchmark import roofline

KERNELS = ("gram_pairs", "gram_power")


def count(work):
    n, m, B = work["n"], work["m"], work["B"]
    nbytes = 4.0 * ((n * m + m) * B + (n * n + n + 2) * B)
    flops = roofline.pair_flops(n, m, B) + roofline.estimate_flops(n, B)
    return nbytes, flops


def read(run):
    return roofline.share_pct(run, KERNELS, count)
