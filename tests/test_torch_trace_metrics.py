"""The benchmark's readers of the program's spans and counters
(``benchmark/metrics/host_self_ms.py``, ``bursts_per_call.py``,
``burst_live_pct.py``, ``precompute_ms.py``, ``resident_live_pct.py``)
through a traced run of every cell on CPU tensors, as
``benchmark/tests/test_harness_cpu.py`` runs the harness: each calls the
plain twins of the card's kernels (``interpret=True``) on 48 lanes. A metric
reads a number in the cells ``BENCHMARK.json`` lists for it, but where the
program no longer takes the path it reads (``SILENT``), and is absent from
the others' result lines.
"""
import functools
import time

import pytest
import torch

from benchmark import run, spec
from fastoptsolver_tpu_torch.utils import profiling

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
NEW = ("host_self_ms", "bursts_per_call", "burst_live_pct", "precompute_ms",
       "resident_live_pct")
LANES = 48


@pytest.fixture(autouse=True)
def _twins(monkeypatch, tmp_path):
    import fastoptsolver_tpu_torch.batch as batch

    monkeypatch.setattr(batch, "solve_lasso_batch",
                        functools.partial(batch.solve_lasso_batch, interpret=True))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    profiling.reset_counters()  # the counters count the run alone, as in a fresh process
    yield
    profiling.reset_counters()


# Listed metrics that read nothing in a cell since the program left the path
# they read: the resident route builds its Gram with the pairs kernel at every
# width of its window, so wide128's call no longer enters the torch precompute
# (PERF.md §7: the benchmark change that moves the cell from precompute_ms's
# list to gram_build_roofline_pct's empties this).
SILENT = {"wide128.bench": {"precompute_ms"}}


def _listed(cell):
    """The program-read metrics ``BENCHMARK.json`` asks of ``cell`` that the
    program's path there gives a reading."""
    return {m["name"] for m in spec.benchmark()["per_layer"]
            if m["name"].split(".")[0] in NEW and cell in m.get("workloads", CELLS)
            } - SILENT.get(cell, set())


@pytest.mark.parametrize("cell", CELLS)
def test_each_program_metric_reads_in_its_cells_and_nowhere_else(cell):
    line, lines = run.run_cell(spec.cell(cell), 2**31 + 11, 0.2, True, torch.device("cpu"),
                               lanes=LANES, t0=time.monotonic())
    assert line["correct"] is True, lines
    got = {name for name in line["metrics"] if name.split(".")[0] in NEW}
    assert got == _listed(cell) and got
    for name in got:
        assert line["metrics"][name]["value"] > 0, name
    c = profiling.counters()
    if "bursts_per_call.wide" in got:  # the cells on the host burst loop
        bursts = line["metrics"]["bursts_per_call.wide"]["value"]
        assert bursts == c["bursts"] / c["calls"] and bursts == int(bursts)
        assert 1 <= bursts <= 40
        live = line["metrics"]["burst_live_pct.wide"]["value"]
        assert 0 < live <= 100
        assert live == 100.0 * c["burst_lanes_live"] / c["burst_lanes"]
    else:
        assert c["bursts"] == 0  # the fused and resident kernels' bursts run inside them
    if "resident_live_pct" in got:  # the cells on the resident engine
        live = line["metrics"]["resident_live_pct"]["value"]
        assert 0 < live <= 100
        assert live == 100.0 * c["resident_lane_steps_live"] / c["resident_lane_steps"]
    else:
        assert c["resident_lane_steps"] == 0
    # the torch precompute's power loop runs in the cells that read its span,
    # but for the resident route, whose kernel estimates L itself
    assert (c["power_steps"] > 0) == ("precompute_ms" in got and "resident_live_pct" not in got)


def test_the_readers_give_nothing_without_the_programs_record(monkeypatch):
    """A program without spans and counters (the parent of this change) gives
    no number, and raises nothing."""
    import sys
    from types import SimpleNamespace

    monkeypatch.setitem(sys.modules, "fastoptsolver_tpu_torch.utils.profiling",
                        SimpleNamespace())
    trace_run = SimpleNamespace(trace=object())
    for name in NEW:
        assert spec.reader(name)(trace_run) is None, name
