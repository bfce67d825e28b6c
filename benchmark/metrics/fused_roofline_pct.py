"""The fused build+solve kernel's share of its roofline, in %.

Bytes: A and b read once; x, iters, gap and done written once. Operations:
the augmented Gram's pair sums, the Lipschitz estimate as one Gram matvec
(``roofline.estimate_flops``), and each lane's own iterations and gap
checks, one Gram matvec each, whatever the lanes around it ran."""
from benchmark import roofline

KERNELS = ("fused_lasso_solve",)


def count(work):
    n, m, B = work["n"], work["m"], work["B"]
    nbytes = 4.0 * ((n * m + m) * B + (n + 3) * B)
    flops = (roofline.pair_flops(n, m, B)
             + roofline.estimate_flops(n, B)
             + roofline.solve_flops(n, work["iters"], work["check_every"]))
    return nbytes, flops


def read(run):
    return roofline.share_pct(run, KERNELS, count)
