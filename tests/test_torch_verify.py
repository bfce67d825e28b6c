"""The port's kernel verification (``fastoptsolver_tpu_torch.bench.verify_tpu``)
on the CPU, where every kernel entry runs its plain twin: each check holds
the twins against the torch driver or float64 NumPy at the reference's
shapes and tolerances, as it holds the kernels on the card.

Also: the check names are the reference's (``df32_efts`` renamed
``f64_certificate``); a perturbed entry fails its check, ``ok`` goes false
and ``main`` exits 1; an error that is no ``AssertionError`` propagates
(except inside ``resident_ceiling_n168``, as in the reference); without a
card ``run()`` raises. ``resident_armijo_resume`` is the one check the twins
do not hold (ROADMAP Queue 3): its Armijo hold is decided by summation
order, which the torch driver shows against itself.
"""
import json
import re
from pathlib import Path

import pytest
import torch

import fastoptsolver_tpu.bench.verify_tpu as J_verify
from fastoptsolver_tpu_torch.batch import fista_gram as driver
from fastoptsolver_tpu_torch.bench import verify_tpu as V
from fastoptsolver_tpu_torch.kernels import fista_vmem, resident

torch.set_num_threads(1)

HELD_ON_THE_TWINS = [n for n in V.CHECK_NAMES if n != "resident_armijo_resume"]


@pytest.fixture(scope="module")
def ctx():
    return V.Inputs("cpu")


@pytest.mark.parametrize("name", HELD_ON_THE_TWINS)
def test_check_holds_on_the_twins(ctx, name):
    out = {}
    getattr(V, name)(ctx, out)
    assert out and all(V.holds(r) for r in out.values()), out


def test_resident_armijo_hold_is_decided_by_summation_order(ctx):
    """``resident_armijo_resume`` at n = 144: the resume is bit-exact, but
    the Armijo x (L/4, 5 iterations) of the resident twin and the driver
    part by more than rtol 2e-3/atol 2e-4 on a lane or two, and so does
    the driver against itself on the same problem with its features
    permuted: the accept test is decided by the f32 rounding of ½bᵀb once
    τ has halved ~15 times. Measured here: twin 1.454 of the allowed,
    driver reorders 0.848, 1.696, 1.696."""
    out = {}
    with pytest.raises(AssertionError, match="Armijo x"):
        V.resident_armijo_resume(ctx, out)
    assert V.holds(out["resumed x max|d|"])
    assert not V.holds(out["Armijo x |d|/(atol + rtol·|ref|)"])
    assert max(V.armijo_reorder_spread(ctx)) > 1.0


def test_check_names_are_the_references():
    """The reference's ``check(...)`` names in its order, its two loops
    expanded, with ``df32_efts`` renamed ``f64_certificate``."""
    src = Path(J_verify.__file__).read_text()
    assert "for n_b, mb in ((20, 250), (64, 264)):" in src
    assert "for n_wide in (20, 64, 96):" in src
    names = []
    for m in re.finditer(r'check\(\s*(f?)"([a-z0-9_{}]+)"', src):
        if m.group(2) == "fused_build_n{n_b}":
            names += ["fused_build_n20", "fused_build_n64"]
        elif m.group(2) == "wide_n{n_wide}":
            names += ["wide_n20", "wide_n64", "wide_n96"]
        else:
            assert not m.group(1), m.group(2)
            names.append(m.group(2))
    assert len(names) == 25
    assert V.CHECK_NAMES == ["f64_certificate" if n == "df32_efts" else n for n in names]


def test_report_keeps_the_references_fields(ctx):
    rep = V.run("cpu", ["fixed_iters", "f64_certificate"])
    assert set(rep) == {"metric", "value", "unit", "ok", "detail", "readings"}
    assert rep["metric"] == "cpu_twin_verification_vs_torch_driver"
    assert rep["value"] == 2 and rep["unit"] == "checks_passed_of_2" and rep["ok"] is True
    assert rep["detail"] == {"fixed_iters": True, "f64_certificate": True, "device": "cpu"}
    assert set(rep["readings"]) == {"fixed_iters", "f64_certificate"}
    json.dumps(rep)
    with pytest.raises(ValueError, match="unknown checks"):
        V.run("cpu", ["df32_efts"])


def _nudged(entry):
    """``entry`` with 1e-3 added to the x it returns."""
    def run(*args, **kw):
        out = entry(*args, **kw)
        if isinstance(out, tuple) and not hasattr(out, "_fields"):
            res, state = out
            return res._replace(x=res.x + 1e-3), state
        return out._replace(x=out.x + 1e-3)
    return run


def test_a_perturbed_entry_fails_its_check_and_main_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(fista_vmem, "fista_gram_vmem", _nudged(fista_vmem.fista_gram_vmem))
    rep = V.run("cpu", ["fixed_iters", "fused_build_n20"])
    assert rep["detail"]["fixed_iters"] is False and rep["detail"]["fused_build_n20"] is True
    assert rep["ok"] is False and rep["value"] == 1
    assert not V.holds(rep["readings"]["fixed_iters"]["x |d|/(atol + rtol·|ref|)"])
    assert "# FAIL fixed_iters" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        V.main(["--device", "cpu", "--check", "fixed_iters"])
    assert exc.value.code == 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["ok"] is False


def test_main_exits_0_when_every_check_holds(capsys):
    with pytest.raises(SystemExit) as exc:
        V.main(["--device", "cpu", "--check", "fixed_iters", "kernel_armijo"])
    assert exc.value.code == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"] is True


def test_an_error_that_is_no_assertion_propagates(monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(driver, "fista_gram_batch", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        V.run("cpu", ["fixed_iters"])


def test_a_launch_failure_at_the_resident_ceiling_is_that_checks_failure(monkeypatch):
    """As in the reference: the n = 168 solve runs inside its check, and a
    build or launch failure there records ``False`` instead of ending the run."""
    def broken(*args, **kw):
        raise RuntimeError("too many resources requested for launch")

    monkeypatch.setattr(resident, "fista_gram_resident", broken)
    rep = V.run("cpu", ["resident_ceiling_n168", "kernel_resume"])
    assert rep["detail"] == {"resident_ceiling_n168": False, "kernel_resume": True,
                             "device": "cpu"}


def test_no_card_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main(["--check", "fixed_iters"])


@pytest.mark.parametrize("reading, held", [
    ({"value": 1.0, "op": "<=", "limit": 1.0}, True),
    ({"value": 1.0, "op": "<", "limit": 1.0}, False),
    ({"value": 0.95, "op": ">", "limit": 0.9}, True),
    ({"value": 0.9, "op": ">=", "limit": 0.9}, True),
    ({"value": 0.0, "op": "==", "limit": 0.0}, True),
    ({"value": [0.95, 1.05], "op": "in", "limit": [0.9, 1.1]}, True),
    ({"value": [0.95, 1.1], "op": "in", "limit": [0.9, 1.1]}, False),
])
def test_holds(reading, held):
    assert V.holds(reading) is held
