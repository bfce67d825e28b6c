"""A driver is new files only: ``gram_stand_in``, which times
``solve_gram_batch`` on a Gram built in set-up and is no cell of
``BENCHMARK.json``, run on CPU tensors by the unchanged ``run.run_cell``
under ``wide96.bench``'s recipe, sizes and limits at 48 lanes. Clean, it
prints the contract's line with ``correct`` true; under each of its faults,
``correct`` comes out false."""
import dataclasses
import time

import pytest
import torch

from benchmark import run, spec
from benchmark.drivers import lasso_batch
from benchmark.tests import gram_stand_in
from benchmark.tests.test_harness_cpu import LANES, check_broken, check_line, patch_entry, twin

FAULTS = ("unchanged", "half_left_out", "x_altered", "flag_flipped")


@pytest.fixture
def stand_in(monkeypatch):
    """``wide96.bench`` as a cell of the stand-in driver, on its twins."""
    monkeypatch.setattr(spec, "driver", lambda config: gram_stand_in)
    twin(monkeypatch, gram_stand_in)
    return dataclasses.replace(spec.cell("wide96.bench"), name="wide96.gram_stand_in")


def _run(cell):
    return run.run_cell(cell, 2**31 + 9, 0.3, False, torch.device("cpu"), lanes=LANES,
                        t0=time.monotonic())


@pytest.mark.parametrize("drv", [lasso_batch, gram_stand_in], ids=lambda d: d.__name__)
def test_a_driver_exports_the_contract(drv):
    assert callable(spec.entry(drv.ENTRY)) and isinstance(drv.TWIN, dict)
    assert tuple(drv.FAULTS) == FAULTS and all(map(callable, drv.FAULTS.values()))
    assert set(drv.EXACT) <= set(drv.LIMITS)
    assert callable(drv.lanes) and callable(drv.solver) and callable(drv.Session)


def test_the_stand_in_prints_the_contracts_line(stand_in):
    line, lines = _run(stand_in)
    check_line(line, lines, stand_in)


@pytest.mark.parametrize("fault", FAULTS)
def test_the_stand_in_broken_is_not_correct(stand_in, fault, monkeypatch):
    patch_entry(monkeypatch, gram_stand_in, gram_stand_in.FAULTS[fault])
    check_broken(*_run(stand_in))
