"""The roofline counts against hand counts at the cells' shapes, and the
trace arithmetic the per-layer readers rest on."""
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import roofline, spec
from benchmark.trace import Trace

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def _work(n, m, B, iters):
    return {"n": n, "m": m, "B": B, "check_every": 25,
            "iters": torch.full((B,), iters, dtype=torch.int64)}


def _count(metric, work):
    return spec.load_module(spec.HERE / "metrics" / f"{metric}.py", f"t_{metric}").count(work)


def test_published_peaks():
    assert H100["bytes_per_s"] == 3.35e12 and H100["f32_flop_per_s"] == 67e12


@pytest.mark.parametrize("B,inputs_ms,bound_ms", [
    (262144, 1.87805, 1.88055),  # boston5.bench: the 1.878 ms of A and b, + outputs
    (16384, 0.117378, 0.117534),  # boston5.small_batch
])
def test_fused_counts_at_the_boston5_cells(B, inputs_ms, bound_ms):
    n, m = 5, 1000
    nbytes, flops = _count("fused_roofline_pct", _work(n, m, B, 50))
    assert 4 * (n * m + m) * B / 3.35e9 == pytest.approx(inputs_ms, rel=1e-5)
    assert nbytes == 4 * (6000 + 8) * B
    # 21 pair sums a row (15 of Q, 5 of c, bᵀb), L as one matvec, 50 steps + 2 checks
    assert flops == 2 * 21 * m * B + 50 * B + 50 * (50 + 2) * B
    assert 1e3 * roofline.bound_s(nbytes, flops, H100) == pytest.approx(bound_ms, rel=1e-5)


def test_gram_build_counts_at_the_wide96_cells():
    n, m, B = 96, 192, 54144
    nbytes, flops = _count("gram_build_roofline_pct", _work(n, m, B, 75))
    assert nbytes == 4 * ((96 * 192 + 192) + (96 * 96 + 96 + 2)) * 54144  # 6.05 GB
    # the pairs (97·98/2 a row, 2 operations each) and L as one matvec (2n²)
    assert flops == 97 * 98 * 192 * 54144 + 2 * 9216 * 54144
    assert 1e3 * flops / 67e12 == pytest.approx(1.48984, abs=1e-5)
    # bound by the bytes: 1.806 ms, against 1.489 ms of operations
    assert 1e3 * roofline.bound_s(nbytes, flops, H100) == pytest.approx(1.80618, abs=1e-5)


def test_the_lipschitz_estimate_counts_one_matvec_whatever_its_steps():
    """L is credited as the one Gram matvec any estimate from Q needs, at
    n = 5 and at n = 96 alike, so a program that iterates fewer power steps
    is held to the same count."""
    for n in (5, 96):
        assert roofline.estimate_flops(n, 7) == 2 * n * n * 7


@pytest.mark.parametrize("iters,checks", [(75, 3), (1000, 40), (30, 2)])
def test_burst_counts_at_the_wide96_cells(iters, checks):
    n, B = 96, 54144
    nbytes, flops = _count("burst_roofline_pct", _work(n, 192, B, iters))
    assert nbytes == 4 * (9216 + 96 + 99) * B  # Q, c in; x, iters, gap, done out
    assert flops == 2 * 9216 * (iters + checks) * B


def test_lanes_count_their_own_iterations():
    iters = torch.tensor([25, 26, 1000, 0])
    assert roofline.solve_flops(4, iters, 25) == 2 * 16 * (1051 + 1 + 2 + 40 + 0)


def test_counts_do_not_depend_on_the_engine():
    """The same small problem through the fused twin and through the torch
    driver: each count is the shapes' work plus 2n² for each iteration and
    check its own lanes ran, and nothing else differs."""
    from benchmark.recipes import boston_like

    config = spec.cell("boston5.bench").config
    drv = spec.driver(config)
    solve, cfg = spec.entry(drv.ENTRY), drv.solver(config)
    A, b, a1 = boston_like.build(torch.Generator().manual_seed(1), 256, m=300, n=5,
                                 noise_grid=[0.5, 5.0], rho1_grid=[0.5, 0.8],
                                 rho2_grid=[0.7, 0.9], alpha_scale=0.1)
    fused = solve(A, b, a1, 0.0, cfg=cfg, feature_major=True, **drv.TWIN)
    driver = solve(A, b, a1, 0.0, cfg=cfg, feature_major=True, backend="xla")
    counts = []
    for res in (fused, driver):
        work = {"n": 5, "m": 300, "B": 256, "check_every": 25, "iters": res.iters.long()}
        nbytes, flops = _count("fused_roofline_pct", work)
        counts.append((nbytes, flops - roofline.solve_flops(5, work["iters"], 25)))
    assert counts[0] == counts[1]


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def _run(trace, work=None, call_ms=(), window_s=0.0):
    return SimpleNamespace(trace=trace, work=work, peaks=H100, call_ms=list(call_ms),
                           window_s=window_s)


def test_trace_reductions():
    """Two calls of 10 ms: each a 1 ms host set-up, a 6 ms fused kernel, a
    0.5 ms copy inside it and a 1 ms torch kernel, then the host's sync."""
    events = []
    for t0 in (0.0, 20000.0):
        events += [_ev("user_annotation", "bench.call", t0, 10000.0),
                   _ev("cpu_op", "aten::empty", t0 + 100, 800),
                   _ev("cuda_runtime", "cudaLaunchKernel", t0 + 950, 40),
                   _ev("kernel", "void fused_lasso_solve_kernel<5, 0, false>(Params)", t0 + 1000,
                       6000),
                   _ev("gpu_memcpy", "Memcpy HtoD", t0 + 2000, 500),
                   _ev("kernel", "at::native::reduce_kernel", t0 + 7000, 1000),
                   _ev("cuda_runtime", "cudaStreamSynchronize", t0 + 1100, 8850),
                   _ev("user_annotation", "bench.count", t0 + 10000, 200)]
    tr = Trace(events)
    assert tr.window() == pytest.approx((0.0, 0.030))
    assert tr.busy_s(0.0, 0.030) == pytest.approx(0.014)
    # the untraced window: 100 calls in 1 s, the median 9 ms, one stall
    untraced = dict(call_ms=[9.0] * 99 + [50.0], window_s=1.0)
    idle = spec.reader("device_idle_pct")(_run(tr, **untraced))
    assert idle == pytest.approx(100 * (1 - 100 * 0.007 / 1.0))
    host = spec.reader("host_overhead_ms")(_run(tr, **untraced))
    assert host == pytest.approx(9.0 - 6.0)
    ops = dict(tr.top_ops(0.0, 0.030))
    assert ops["at::native::reduce_kernel"] == pytest.approx(0.002)
    gaps = dict(tr.idle_gaps(0.0, 0.030))
    # named halfway through each gap: the first call's set-up, the 13 ms from
    # the first call's last kernel to the second's launch, the last 2 ms
    assert gaps["bench.call / aten::empty"] == pytest.approx(0.001)
    assert gaps["between spans / python"] == pytest.approx(0.013)
    assert gaps["bench.call / cudaStreamSynchronize"] == pytest.approx(0.002)
    assert sum(gaps.values()) == pytest.approx(0.016)
    # the fused kernel's share: bytes of (5, 1000, 262144) over 6 ms
    work = _work(5, 1000, 262144, 50)
    share = spec.reader("fused_roofline_pct")(_run(tr, work))
    assert share == pytest.approx(100 * 1.88055 / 6.0, rel=1e-4)
    assert spec.reader("burst_roofline_pct")(_run(tr, work)) is None  # no such kernel ran


def test_readers_read_nothing_without_a_trace():
    for name in ("device_idle_pct", "host_overhead_ms", "fused_roofline_pct"):
        assert spec.reader(name)(_run(None)) is None
    assert math.isclose(roofline.bound_s(3.35e12, 0.0, H100), 1.0)
