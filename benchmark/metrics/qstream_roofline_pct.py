"""The Q-streaming engine's share of its roofline, in %: the certified solve
on a given Gram past the resident window, every launch of the call summed
(``qstream_cluster_kernel`` and the streaming ``qstream_kernel`` alike).

The count is the burst engine's (``burst_roofline_pct.count``), so any
engine that does this work is held to one yardstick. Bytes: Q and c read
once; x, iters, gap and done written once. Operations: each lane's own
iterations and gap checks, one Gram matvec (2n²) each, not the bursts the
lanes run in lockstep. Q's re-layout for the clusters is the engine's
choice and is not counted."""
from benchmark import roofline, spec

KERNELS = ("qstream",)

count = spec.load_module(spec.HERE / "metrics" / "burst_roofline_pct.py",
                         "benchmark.metrics.burst_roofline_pct").count


def read(run):
    return roofline.share_pct(run, KERNELS, count)
