"""The harness end to end on CPU tensors: the result line, and ``correct``
coming out false when the timed path is broken underneath.

On a CPU tensor ``solve_lasso_batch`` would take the torch driver, another
engine with another f32 floor than the card's; the runs here pass
``interpret=True`` so that the call takes the plain twins of the card's own
kernels (the fused kernel's at n = 5; the Gram build's and the burst
engine's at n = 96), whose arithmetic the cells' limits were read on.

The faults are those a one-card lasso cell can have: a solve that returns
its state unchanged, half of the batch left out, one answer altered where it
is produced (its x, or its flag). The exchange between cards does not exist
on one card.
"""
import functools
import json
import time

import pytest
import torch

from benchmark import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
LANES = 48


@pytest.fixture(autouse=True)
def _twins(monkeypatch):
    import fastoptsolver_tpu_torch.batch as batch

    monkeypatch.setattr(batch, "solve_lasso_batch",
                        functools.partial(batch.solve_lasso_batch, interpret=True))


def _run(cell, trace=False, seconds=0.3, seed=2**31 + 5):
    return run.run_cell(spec.cell(cell), seed, seconds, trace, torch.device("cpu"),
                        lanes=LANES, t0=time.monotonic())


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contracts_line(cell):
    line, lines = _run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert line["correct"] is True, lines
    assert line["failed"] == 0 and line["attempted"] % LANES == 0 and line["attempted"] > 0
    c = spec.cell(cell)
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


def _unchanged(solve):
    def broken(A, b, a1, a2, **kw):
        res = solve(A, b, a1, a2, **kw)
        return res._replace(x=torch.zeros_like(res.x), converged=torch.zeros_like(res.converged),
                            rel_gap=torch.full_like(res.rel_gap, float("inf")))
    return broken


def _half_left_out(solve):
    def broken(A, b, a1, a2, **kw):
        h = A.shape[-1] // 2
        part = solve(A[..., :h].contiguous(), b[..., :h].contiguous(), a1[:h], a2, **kw)
        pad = lambda v, fill: torch.cat([v, torch.full((A.shape[-1] - h, *v.shape[1:]), fill,
                                                       dtype=v.dtype)])
        return part._replace(x=pad(part.x, 0.0), iters=pad(part.iters, 0),
                             rel_gap=pad(part.rel_gap, float("inf")),
                             converged=pad(part.converged, False), failed=pad(part.failed, False))
    return broken


def _x_altered(solve):
    def broken(A, b, a1, a2, **kw):
        res = solve(A, b, a1, a2, **kw)
        x = res.x.clone()
        x[3] *= 1.01
        return res._replace(x=x)
    return broken


def _flag_flipped(solve):
    def broken(A, b, a1, a2, **kw):
        res = solve(A, b, a1, a2, **kw)
        converged = res.converged.clone()
        converged[3] = ~converged[3]
        return res._replace(converged=converged)
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _x_altered, _flag_flipped])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import fastoptsolver_tpu_torch.batch as batch

    monkeypatch.setattr(batch, "solve_lasso_batch", fault(batch.solve_lasso_batch))
    line, lines = _run(cell)
    assert line["correct"] is False, lines
    assert any(v["value"] > v["limit"] for v in line["check"].values())
