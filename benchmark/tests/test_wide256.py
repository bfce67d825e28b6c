"""The wide256 cell's readers and limits: the Q-streaming engine's counts
against a hand count, the precompute reader's silence without spans, and
the control that the cell's comparison must call wrong."""
import sys
from types import SimpleNamespace

import pytest

from benchmark import roofline, spec
from benchmark.tests.test_counts import H100, _count, _run, _work
from benchmark.tests.test_reference import test_the_control_is_not_correct as _control


@pytest.mark.parametrize("iters,checks", [(1000, 40), (75, 3)])
def test_qstream_counts_at_the_wide256_cell(iters, checks):
    """The Q-streaming engine's solve at wide256's shape, counted by hand,
    and by the burst engine's count for the same work."""
    work = _work(256, 512, 7552, iters)
    nbytes, flops = _count("qstream_roofline_pct", work)
    assert nbytes == 4 * (65536 + 256 + 259) * 7552  # Q, c in; x, iters, gap, done out
    assert flops == 2 * 65536 * (iters + checks) * 7552
    assert (nbytes, flops) == _count("burst_roofline_pct", work)
    # 1.995 GB of bytes take 0.596 ms; 1000 iterations and 40 checks 15.365 ms
    # of operations, which bound the solve
    if iters == 1000:
        assert 1e3 * roofline.bound_s(nbytes, flops, H100) == pytest.approx(15.3649, abs=1e-4)


def test_precompute_ms_reads_nothing_without_a_trace_or_the_programs_spans(monkeypatch):
    """No trace, no record (a program without spans), or no call that ran
    the torch precompute: no number. Otherwise the median of the calls after
    the first, each its precompute spans summed."""
    read = spec.reader("precompute_ms")
    key = "fastoptsolver_tpu_torch.utils.profiling"
    assert read(_run(None)) is None
    monkeypatch.setitem(sys.modules, key, SimpleNamespace())
    assert read(_run(object())) is None
    rows = []
    for call, ms in ((1, 9.0), (2, 4.0), (3, 6.0), (4, 5.0)):
        root = len(rows)
        rows.append((call, "fos.solve_lasso_batch", None, 0, 20_000_000))
        rows.append((call, "fos.gram_build", root, 0, 15_000_000))
        rows.append((call, "fos.gram_precompute", root + 1, 1_000_000,
                     1_000_000 + int(ms * 1e6)))
    monkeypatch.setitem(sys.modules, key, SimpleNamespace(spans=lambda: rows))
    assert read(_run(None)) is None
    assert read(_run(object())) == pytest.approx(5.0)  # of 4, 6 and 5 ms
    monkeypatch.setitem(sys.modules, key, SimpleNamespace(
        spans=lambda: [r for r in rows if r[1] != "fos.gram_precompute"]))
    assert read(_run(object())) is None  # a call on the build kernels


def test_the_control_is_not_correct_at_wide256():
    """The reference one precision below float32 fails wide256's limits, as
    it does every other cell's."""
    _control("wide256.bench")
