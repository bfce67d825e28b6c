"""The resident engine's share of its roofline, in %: the certified solve on a
Gram built without L, in one ``resident`` launch that estimates L itself.

The count is the burst engine's (``burst_roofline_pct.count``: Q and c read
once; x, iters, gap and done written once; each lane's own iterations and
gap checks, one Gram matvec (2n²) each), plus the Lipschitz estimate as one
Gram matvec (``roofline.estimate_flops``). It is the work, not how the kernel
moves it: the upper triangle it holds, its power steps past the first and
the steps a certified lane runs until its group exits are not credited."""
from benchmark import roofline, spec

KERNELS = ("resident",)

_solve = spec.load_module(spec.HERE / "metrics" / "burst_roofline_pct.py",
                          "benchmark.metrics.burst_roofline_pct").count


def count(work):
    nbytes, flops = _solve(work)
    return nbytes, flops + roofline.estimate_flops(work["n"], work["B"])


def read(run):
    return roofline.share_pct(run, KERNELS, count)
