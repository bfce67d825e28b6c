"""The harness end to end on CPU tensors: the result line, and ``correct``
coming out false when the timed path is broken underneath.

The tests reach the timed call only through each cell's driver
(``spec.py``'s contract): its ``ENTRY`` is patched with its ``TWIN``, so that
the call takes the plain twins of the card's own kernels (the fused
kernel's at n = 5; the Gram build's and the burst engine's at n = 96), and,
for each of its ``FAULTS``, with the twin broken underneath.
"""
import functools
import json
import time

import pytest
import torch

from benchmark import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
LANES = 48


def _driver(cell):
    return spec.driver(spec.cell(cell).config)


def patch_entry(monkeypatch, drv, wrap):
    """Put ``wrap(entry)`` where ``drv``'s session looks its entry up."""
    monkeypatch.setattr(".".join(drv.ENTRY), wrap(spec.entry(drv.ENTRY)))


def twin(monkeypatch, drv):
    """Send ``drv``'s entry to the plain twins of the card's kernels."""
    patch_entry(monkeypatch, drv, lambda f: functools.partial(f, **drv.TWIN))


@pytest.fixture(autouse=True)
def _twins(monkeypatch):
    for drv in {_driver(cell) for cell in CELLS}:
        twin(monkeypatch, drv)


def _run(cell, trace=False, seconds=0.3, seed=2**31 + 5):
    return run.run_cell(spec.cell(cell), seed, seconds, trace, torch.device("cpu"),
                        lanes=LANES, t0=time.monotonic())


def check_line(line, lines, c):
    """``line`` is the contract's, untraced, with ``correct`` true."""
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert line["correct"] is True, lines
    assert line["failed"] == 0 and line["attempted"] % LANES == 0 and line["attempted"] > 0
    units = {m["name"]: m["unit"] for m in c.end_to_end}
    assert set(line["metrics"]) <= set(units) and "setup_s" in line["metrics"]
    assert any(name.split(".")[0] == "certified_per_s" for name in line["metrics"])
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["check"]) == set(c.limits)
    # each number compared, beside its limit, ends the lines for standard error
    assert [t.split()[1] for t in lines[-len(c.limits):]] == list(c.limits)
    json.dumps(line)


def check_broken(line, lines):
    assert line["correct"] is False, lines
    assert any(v["value"] > v["limit"] for v in line["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contracts_line(cell):
    line, lines = _run(cell)
    check_line(line, lines, spec.cell(cell))


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    line, _ = _run("boston5.small_batch", trace=True)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in spec.cell("boston5.small_batch").per_layer}
    assert set(line["metrics"]) <= per_layer
    assert any(name.split(".")[0] == "host_overhead_ms" for name in line["metrics"])
    assert list(line)[-1] == "check"
    assert list(tmp_path.rglob("*.json"))


@pytest.mark.parametrize("cell,fault", [(cell, fault) for cell in CELLS
                                        for fault in _driver(cell).FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    drv = _driver(cell)
    patch_entry(monkeypatch, drv, drv.FAULTS[fault])
    check_broken(*_run(cell))
