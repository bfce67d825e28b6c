"""On the card: a cell run in a fresh process by its command line, traced
and not, and the control failing at the cell's own size. Run there with
``python -m pytest -o addopts="" -m cuda benchmark/tests/test_card.py``."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import spec
from benchmark.checks import lasso as check
from benchmark.reference import lasso


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cell, seed, trace):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                          str(seed), "--seconds", "1", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["boston5.small_batch", "wide96.high_alpha"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    _card()
    line = _run(cell, 2**31 + 101, trace)
    c = spec.cell(cell)
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    wanted = c.per_layer if trace else c.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in wanted}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
        for m in line["metrics"]:
            if m.endswith("_roofline_pct"):
                assert 0 < line["metrics"][m]["value"] <= 100


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    _card()
    c = spec.cell("boston5.small_batch")
    s = spec.driver(c.config).Session(c, 2**31 + 103, torch.device("cuda", 0))
    x, conv, gap, iters = lasso.control(s.A, s.b, s.alpha1, tol=s.cfg.rel_gap_tol,
                                        max_iter=s.cfg.max_iter, check_every=s.cfg.check_every)
    s.kept = [check.Answer(x, conv, gap, iters)]
    correct, held = s.judge(s.readings())
    assert not correct, held
