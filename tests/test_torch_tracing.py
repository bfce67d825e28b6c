"""The program's spans and counters (``utils.profiling``) on the routed
surface, on the kernels' plain twins (``interpret=True``): the fused route at
n = 5 and the Gram build and burst engine at n = 96, m = 192; and the stages
of the torch Gram precompute (``make_gram_batch``) and the Q-streaming
engine's re-layout of Q, called on their own.

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
from fastoptsolver_tpu_torch.batch.fista_gram import make_gram_batch
from fastoptsolver_tpu_torch.kernels import qstream
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


def _precompute(n=12, m=30, B=16, **kw):
    """``make_gram_batch`` on the instance-major layout of :func:`_batch`."""
    A, b, a1 = _batch(n, m, B)
    return make_gram_batch(A.permute(2, 1, 0), b.T, a1, 0.0, **kw)


def _tree(rows, index):
    """The names of ``rows[index]``'s children, in order."""
    return [row[1] for row in rows if row[2] == index]


@pytest.mark.parametrize("power_iters,power_tol,steps", [
    (5, 0.0, 5),  # no lane ever stops moving: every step, a read before each
    (100, 1e30, 1),  # every lane stops after the first step: a read says so
    (100, 1e-6, None),  # the default stop
])
def test_the_precompute_spans_its_stages_and_counts_its_power_steps(power_iters, power_tol,
                                                                    steps):
    """``fos.gram_precompute`` holds ``fos.gram_products`` and
    ``fos.lipschitz``, which holds one ``fos.sync`` a host read of the power
    loop: a read before each step, and one more where the loop stops before
    ``power_iters``; ``power_steps`` counts the steps. The bits are those
    made with no profiler."""
    kw = dict(power_iters=power_iters, power_tol=power_tol)
    plain = _precompute(**kw)
    plain_steps = profiling.counters()["power_steps"]
    profiling.reset_counters()
    traced = _profiled(lambda: _precompute(**kw))
    for f in ("Q", "c", "btb", "alpha1", "alpha2", "L"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
    rows = profiling.spans()
    assert rows[0][1] == "fos.gram_precompute" and rows[0][2] is None
    assert _tree(rows, 0) == ["fos.gram_products", "fos.lipschitz"]
    lipschitz = next(i for i, row in enumerate(rows) if row[1] == "fos.lipschitz")
    reads = _tree(rows, lipschitz)
    assert reads and set(reads) == {"fos.sync"}
    assert all(row[3] >= rows[0][3] and row[4] <= rows[0][4] for row in rows)
    k = profiling.counters()["power_steps"]
    assert k == plain_steps and k <= power_iters
    assert len(reads) == (k if k == power_iters else k + 1)
    if steps is not None:
        assert k == steps
    profiling.reset_counters()
    _precompute(L=torch.ones(16))  # a finished L: no estimate, no step
    assert profiling.counters()["power_steps"] == 0


def test_host_self_time_leaves_the_power_loops_reads_out():
    """``host_self_ms``'s reader takes the precompute's ``fos.sync`` reads
    out of a call's root span, as it takes the burst loop's."""
    from types import SimpleNamespace

    from benchmark import spec

    def calls():
        for _ in range(3):
            with profiling.span("fos.solve_lasso_batch"):
                _precompute(power_tol=0.0)

    _profiled(calls)
    rows = profiling.spans()
    roots = {row[0]: row[4] - row[3] for row in rows if row[2] is None}
    waits = {c: sum(row[4] - row[3] for row in rows if row[0] == c and row[1] == "fos.sync")
             for c in roots}
    assert len(roots) == 3 and all(waits[c] > 0 for c in roots)
    own = sorted(roots[c] - waits[c] for c in sorted(roots)[1:])
    got = spec.reader("host_self_ms")(SimpleNamespace(trace=object()))
    assert got == pytest.approx(1e-6 * (own[0] + own[1]) / 2)
    assert got < 1e-6 * min(roots[c] for c in sorted(roots)[1:])
    stage = sorted(row[4] - row[3] for row in rows
                   if row[1] == "fos.gram_precompute" and row[0] != min(roots))
    got = spec.reader("precompute_ms")(SimpleNamespace(trace=object()))
    assert got == pytest.approx(1e-6 * (stage[0] + stage[1]) / 2)


def test_a_relayout_is_counted_and_spanned():
    Q = torch.randn((20, 20, 3))
    qstream.relayout(Q, 2)
    assert profiling.counters()["qstream_relayouts"] == 1
    _profiled(lambda: qstream.relayout(Q, 4))
    assert [row[1] for row in profiling.spans()] == ["fos.relayout"]
    assert profiling.counters()["qstream_relayouts"] == 2
