"""On the card: the wide128 cell run in a fresh process by its command line,
traced and not, as ``test_card.py`` runs its cells, and the control failing
at the cell's own size. Run there with ``python -m pytest -o addopts="" -m
cuda benchmark/tests/test_card_wide128.py``."""
import pytest
import torch

from benchmark import spec
from benchmark.checks import lasso as check
from benchmark.reference import lasso
from benchmark.tests.test_card import _card
from benchmark.tests.test_card import test_a_cell_runs_correct_on_the_card as _runs_correct

CELL = "wide128.bench"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_wide128_runs_correct_on_the_card(trace):
    _runs_correct(CELL, trace)


@pytest.mark.cuda
def test_the_control_fails_at_wide128s_size():
    _card()
    c = spec.cell(CELL)
    s = spec.driver(c.config).Session(c, 2**31 + 107, torch.device("cuda", 0))
    x, conv, gap, iters = lasso.control(s.A, s.b, s.alpha1, tol=s.cfg.rel_gap_tol,
                                        max_iter=s.cfg.max_iter, check_every=s.cfg.check_every)
    s.kept = [check.Answer(x, conv, gap, iters)]
    correct, held = s.judge(s.readings())
    assert not correct, held
    assert all(v["value"] > v["limit"] for k, v in held.items() if k != "flags_off"), held
