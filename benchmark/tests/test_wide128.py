"""The wide128 cell's readers and limits: the resident engine's counts against
a hand count, the live share's silence without the program's counters, and
the control that the cell's comparison must call wrong."""
import sys
from types import SimpleNamespace

import pytest

from benchmark import roofline, spec
from benchmark.tests.test_counts import H100, _count, _run, _work
from benchmark.tests.test_reference import test_the_control_is_not_correct as _control


@pytest.mark.parametrize("iters,checks", [(1000, 40), (75, 3)])
def test_resident_counts_at_the_wide128_cell(iters, checks):
    """The resident engine's solve at wide128's shape, counted by hand: the
    burst engine's count for the same solve, and L as one Gram matvec."""
    n, B = 128, 30464
    work = _work(n, 256, B, iters)
    nbytes, flops = _count("resident_roofline_pct", work)
    assert nbytes == 4 * (16384 + 128 + 131) * B  # Q, c in; x, iters, gap, done out
    assert flops == 2 * 16384 * (iters + checks) * B + 2 * 16384 * B
    solve_bytes, solve_flops = _count("burst_roofline_pct", work)
    assert (nbytes, flops) == (solve_bytes, solve_flops + roofline.estimate_flops(n, B))
    if iters == 1000:
        # 2.028 GB take 0.605 ms; 1.039e12 operations 15.510 ms, which bound it
        assert nbytes == 2_028_049_408
        assert flops == pytest.approx(1.03917e12, rel=1e-5)
        assert 1e3 * roofline.bound_s(nbytes, flops, H100) == pytest.approx(15.510, abs=1e-3)


def test_resident_live_pct_reads_nothing_without_the_programs_counters(monkeypatch):
    """No program, a program without counters, or no resident run: no
    number. Otherwise the live steps over the group's steps, over the run."""
    read = spec.reader("resident_live_pct")
    key = "fastoptsolver_tpu_torch.utils.profiling"
    monkeypatch.delitem(sys.modules, key, raising=False)
    assert read(_run(None)) is None
    monkeypatch.setitem(sys.modules, key, SimpleNamespace())
    assert read(_run(None)) is None
    counts = {"calls": 3, "resident_lane_steps": 0, "resident_lane_steps_live": 0}
    monkeypatch.setitem(sys.modules, key, SimpleNamespace(counters=lambda: counts))
    assert read(_run(None)) is None  # a run on another engine
    counts.update(resident_lane_steps=3_000_000, resident_lane_steps_live=1_200_000)
    assert read(_run(None)) == pytest.approx(40.0)


def test_the_control_is_not_correct_at_wide128():
    """The reference one precision below float32 fails wide128's limits, as
    it does every other cell's."""
    _control("wide128.bench")
