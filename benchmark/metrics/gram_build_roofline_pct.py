"""The Gram build's share of its roofline, in %: the stage from raw A and b
to Q, c, bᵀb and L, over its launches (``gram_pairs``, and ``gram_power``
where the build estimates L).

Bytes: A and b read once; Q (n×n), c, bᵀb and L written once. Operations:
the augmented Gram's pair sums and the Lipschitz estimate as one Gram
matvec (``roofline.estimate_flops``), however many steps ``gram_power``
takes. The resident route's build (``wide128.bench``) runs ``gram_pairs``
alone and leaves L to the resident kernel; the count still holds L's one
matvec there (0.76% of it at n = 128, m = 256), which
``resident_roofline_pct`` counts as well."""
from benchmark import roofline

KERNELS = ("gram_pairs", "gram_power")


def count(work):
    n, m, B = work["n"], work["m"], work["B"]
    nbytes = 4.0 * ((n * m + m) * B + (n * n + n + 2) * B)
    flops = roofline.pair_flops(n, m, B) + roofline.estimate_flops(n, B)
    return nbytes, flops


def read(run):
    return roofline.share_pct(run, KERNELS, count)
