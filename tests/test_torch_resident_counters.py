"""The resident engine's lane-step counters (``resident_lane_steps``,
``resident_lane_steps_live`` in ``utils.profiling``) on the plain twin at
n = 128 with a ragged last group (B = 13 lanes, 6 a group): each is the sum
of what the run returned (its ``k`` and its ``iters``), a run resumed from a
checkpoint adds only its own steps, and counting leaves the solve's bits as
they were. α₁ spreads over the lanes, so lanes certify at different bursts
and a group runs on past some of its lanes' certificates."""
import dataclasses

import pytest
import torch

from fastoptsolver_tpu_torch.batch.fista_gram import BatchFISTAConfig, make_gram_batch
from fastoptsolver_tpu_torch.kernels import resident
from fastoptsolver_tpu_torch.utils import profiling

N, M, B, G = 128, 256, 13, 6
EST = 96  # the routed call's in-kernel L estimate
CFG = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
NAMES = ("resident_lane_steps", "resident_lane_steps_live")


@pytest.fixture(scope="module")
def gram():
    """wide_n's recipe at n = 128 (A ~ N(0, 1/n), a 10%-sparse x of N(0, 9),
    noise 0.1), α₁ from 0.05 to 0.5 of each lane's ‖Aᵀb‖∞; built as the
    resident route builds it, without L."""
    g = torch.Generator().manual_seed(128)
    A = torch.randn((B, M, N), generator=g) / N ** 0.5
    x = 3.0 * torch.randn((B, N), generator=g) * (torch.rand((B, N), generator=g) < 0.1)
    b = torch.einsum("bmn,bn->bm", A, x) + 0.1 * torch.randn((B, M), generator=g)
    a1 = torch.linspace(0.05, 0.5, B) * torch.einsum("bmn,bm->bn", A, b).abs().amax(1)
    return make_gram_batch(A, b, a1, 0.0, estimate_l=False)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _solve(gb, cfg=CFG, state0=None):
    return resident.fista_gram_resident_reference(gb, cfg, state0=state0, return_state=True,
                                                  est_l_iters=EST, b_tile=G)


def _counted():
    c = profiling.counters()
    return c[NAMES[0]], c[NAMES[1]]


def test_the_counters_are_the_sums_of_the_returned_k_and_iters(gram):
    res, st = _solve(gram)
    steps, live = _counted()
    assert steps == int(st.k.sum()) and live == int(st.iters.sum())
    assert bool((st.iters <= st.k).all())  # no lane runs past its group
    assert live < steps  # certified lanes waited on their group
    assert len(set(st.k.tolist())) > 1  # the groups stopped apart
    assert profiling.counters()["launches.resident"] == 0  # the twin launches nothing
    _solve(gram)
    assert _counted() == (2 * steps, 2 * live)  # summed over runs


def test_a_resumed_solve_adds_only_its_own_steps(gram):
    _, straight = _solve(gram)
    whole = _counted()
    profiling.reset_counters()
    _, mid = _solve(gram, dataclasses.replace(CFG, max_iter=100))
    first = _counted()
    assert first == (int(mid.k.sum()), int(mid.iters.sum()))
    profiling.reset_counters()
    _, end = _solve(gram, state0=mid)
    assert torch.equal(end.k, straight.k) and torch.equal(end.iters, straight.iters)
    assert _counted() == (int((end.k - mid.k).sum()), int((end.iters - mid.iters).sum()))
    assert tuple(a + b for a, b in zip(first, _counted())) == whole


def test_counting_leaves_the_bits(gram, monkeypatch):
    """x and the state, bit for bit, with the tally and without it (the
    path as it was before the counters)."""
    res, st = _solve(gram)
    monkeypatch.setattr(resident, "_count_lane_steps", lambda out, rows: None)
    profiling.reset_counters()
    plain, plain_st = _solve(gram)
    assert _counted() == (0, 0)
    assert torch.equal(res.x, plain.x)
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(plain_st, f)), f


def test_reset_clears_the_device_tally(gram):
    _solve(gram, dataclasses.replace(CFG, max_iter=50))
    assert _counted()[0] > 0
    profiling.reset_counters()
    assert _counted() == (0, 0)
