"""The program's spans and counters (``utils.profiling``) on the routed
surface, on the kernels' plain twins (``interpret=True``): the fused route at
n = 5 and the Gram build and burst engine at n = 96, m = 192.

With no profiler a span is the shared no-op and nothing is recorded; under a
CPU ``torch.profiler`` the spans nest, one call id a call, and each is a
``user_annotation`` range of the exported trace at the time the record
gives (a call's median span within 20 µs); the burst counters add up to what the returned lanes say; and the
results are the same bits whether a profiler records or not.
"""
import json

import pytest
import torch

from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
from fastoptsolver_tpu_torch.utils import profiling

CFG = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
# (n, m, lanes): the fused route, and the build and burst route
ROUTES = {"fused": (5, 200, 64), "wide": (96, 192, 48)}


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _batch(n, m, B, seed=7):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((n, m, B), generator=g) / n ** 0.5
    keep = torch.rand((n, B), generator=g) < 0.3
    x = torch.where(keep, 3.0 * torch.randn((n, B), generator=g), 0.0)
    b = torch.einsum("nmb,nb->mb", A, x) + 0.1 * torch.randn((m, B), generator=g)
    a1 = 0.1 * torch.einsum("nmb,mb->nb", A, b).abs().amax(dim=0)
    return A, b, a1


def _solve(batch):
    A, b, a1 = batch
    return solve_lasso_batch(A, b, a1, 0.0, cfg=CFG, feature_major=True, interpret=True)


def _profiled(fn, path=None):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def test_without_a_profiler_a_span_is_the_shared_no_op_and_nothing_is_kept():
    _profiled(lambda: None)  # a profiler's start clears the record
    assert profiling.spans() == []
    assert profiling.span("fos.route") is profiling.span("fos.plan") is profiling._OFF
    with profiling.span("fos.route") as s:
        assert s is profiling._OFF
    _solve(_batch(*ROUTES["fused"]))
    assert profiling.spans() == []
    assert profiling.counters()["calls"] == 1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_nest_by_call_and_sit_on_the_profilers_timeline(route, tmp_path):
    batch = _batch(*ROUTES[route])
    path = tmp_path / "trace.json"
    _profiled(lambda: [_solve(batch) for _ in range(3)], path)
    rows = profiling.spans()
    assert rows and all(end is not None and end >= start for *_, start, end in rows)
    calls = sorted({row[0] for row in rows})
    assert len(calls) == 3
    for call in calls:
        mine = [(i, row) for i, row in enumerate(rows) if row[0] == call]
        root_index, root = mine[0]
        assert root[1] == "fos.solve_lasso_batch" and root[2] is None
        for i, (_, name, parent, start, end) in mine[1:]:
            assert parent is not None and rows[parent][0] == call and parent < i
            assert rows[parent][3] <= start and end <= rows[parent][4]
        names = {row[1] for _, row in mine}
        want = {"fos.route", "fos.plan", "fos.result"}
        want |= {"fos.gram_build", "fos.burst_loop", "fos.sync"} if route == "wide" else set()
        assert want <= names, names
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    events = sorted((e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
                     and e["name"].startswith("fos.")), key=lambda e: e["ts"])
    assert [e["name"] for e in events] == [row[1] for row in rows]
    # every call after the first, which warms the profiler, sits on the
    # trace's clock; one span's opening can be preempted on a shared host
    # (once by 5 ms), so each call is held by its median span
    for call in calls[1:]:
        off = [abs((row[3] - base) / 1e3 - e["ts"]) for row, e in zip(rows, events)
               if row[0] == call]
        assert sorted(off)[len(off) // 2] <= 20.0, sorted(off)


def test_the_burst_counters_add_up_to_the_returned_lanes():
    n, m, B = ROUTES["wide"]
    res = _solve(_batch(n, m, B))
    c = profiling.counters()
    k = int(res.n_iters_total)
    assert c["calls"] == 1 and c["bursts"] == k // CFG.check_every
    assert c["burst_lanes"] == B * c["bursts"]
    assert c["burst_lanes_live"] * CFG.check_every == int(res.iters.sum())
    assert 0 < c["burst_lanes_live"] < c["burst_lanes"]  # some lanes certify early
    assert all(v == 0 for name, v in c.items() if name.startswith("launches."))
    profiling.reset_counters()
    _solve(_batch(*ROUTES["fused"]))  # the fused kernel's bursts run inside it
    assert profiling.counters()["calls"] == 1 and profiling.counters()["bursts"] == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_recording_profiler_changes_no_bit_of_the_result(route):
    batch = _batch(*ROUTES[route])
    plain = _solve(batch)
    traced = _profiled(lambda: _solve(batch))
    for name in ("x", "iters", "rel_gap", "converged", "failed", "n_iters_total"):
        assert torch.equal(getattr(plain, name), getattr(traced, name)), name


def test_a_launch_is_counted_once_it_returns_and_spanned_under_a_profiler():
    @profiling.launch("fused")
    def fine(x):
        return x + 1

    @profiling.launch("fused")
    def refused(x):
        raise ValueError("refused")

    assert fine(1) == 2 and fine.__name__ == "fine"
    with pytest.raises(ValueError):
        refused(1)
    assert profiling.counters()["launches.fused"] == 1
    _profiled(lambda: fine(2))
    assert [row[1] for row in profiling.spans()] == ["fos.launch.fused"]
    assert profiling.counters()["launches.fused"] == 2
    with pytest.raises(ValueError, match="no counter"):
        profiling.launch("nothing")


def test_a_full_record_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)

    def spans():
        for _ in range(5):
            with profiling.span("fos.route"):
                pass

    _profiled(spans)
    assert len(profiling.spans()) == 3
    assert profiling.counters()["spans_dropped"] == 2
