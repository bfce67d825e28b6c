"""The torch Gram precompute's Lipschitz estimate split as its CUDA kernel
splits it (``kernels.lipschitz``), held against the eager loop
(``batch.fista_gram._power_loop``) on the CPU.

The plain twin runs every step and keeps each step's estimate, then
``stop_step`` picks the loop's stopping step on the device and the host reads
it once: on CPU tensors ``lipschitz.power_L`` is ``torch.equal`` to
``_batched_power_L`` (the loop there) in every stopping case, with the same
``power_steps``, and each row of its history is the loop after that many
steps. Also: which input takes the kernel (a CUDA float32 Q inside the
cluster window, read from the C export, which a stand-in plays here), and
the spans of the one-read path. The kernel itself is held against the loop on the card in
``tests/test_torch_cuda.py``.
"""
from types import SimpleNamespace

import pytest
import torch

from fastoptsolver_tpu_torch.batch import fista_gram as F
from fastoptsolver_tpu_torch.kernels import _build, lipschitz
from fastoptsolver_tpu_torch.utils import profiling

B, M, N = 12, 24, 8


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _grams(dtype, spiked=range(B), seed=0):
    """(n, n, B) Grams scaled to λ ~ 1 and a start (n, B): lanes in
    ``spiked`` share a strong common factor, so their power steps settle in
    a few steps; the others settle slowly."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((B, M, N), generator=g, dtype=torch.float64)
    s = torch.zeros((B, 1, 1), dtype=torch.float64)
    s[list(spiked)] = 2.0
    A = A + s * torch.randn((B, M, 1), generator=g, dtype=torch.float64)
    Q = torch.einsum("bmi,bmj->ijb", A, A) / (M * N)
    v0 = torch.randn((N, B), generator=g, dtype=torch.float64)
    return Q.to(dtype), v0.to(dtype)


def _with_lane(Q, lane, value):
    Q = Q.clone()
    Q[:, :, lane] = value
    return Q


# case -> (Grams and start, n_iter, tol, the steps the loop takes: a number,
# or "early" for fewer than n_iter)
CASES = {
    "stops_early": (lambda dt: _grams(dt), 100, 1e-5, "early"),
    "lanes_settle_at_different_steps": (lambda dt: _grams(dt, spiked=range(6)), 100, 1e-3,
                                        "early"),
    "reaches_the_cap": (lambda dt: _grams(dt, spiked=()), 7, 1e-12, 7),
    "nan_lane": (lambda dt: (lambda Q, v: (_with_lane(Q, 3, float("nan")), v))(*_grams(dt)),
                 100, 1e-5, "early"),
    "zero_lane": (lambda dt: (lambda Q, v: (_with_lane(Q, 2, 0.0), v))(*_grams(dt)),
                  100, 1e-5, "early"),
    "no_steps": (lambda dt: _grams(dt), 0, 1e-6, 0),
    "one_step": (lambda dt: _grams(dt), 1, 1e-6, 1),
    "tol_zero": (lambda dt: _grams(dt), 30, 0.0, 30),
}


def _same(a, b):
    """Equal bits, NaN where the other has NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _steps(fn):
    profiling.reset_counters()
    out = fn()
    return out, profiling.counters()["power_steps"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_the_twin_and_its_stop_are_the_loop(case, dtype):
    make, n_iter, tol, want = CASES[case]
    Q, v0 = make(dtype)
    loop, k_loop = _steps(lambda: F._batched_power_L(Q, v0, n_iter, tol))
    twin, k_twin = _steps(lambda: lipschitz.power_L(Q, v0, n_iter, tol))
    assert _same(twin, loop), case
    assert k_twin == k_loop
    assert k_loop < n_iter if want == "early" else k_loop == want
    if case == "nan_lane":
        assert torch.isnan(loop[3]) and not torch.isnan(loop[torch.arange(B) != 3]).any()
    if case == "zero_lane":
        assert loop[2] == 0.0 and bool((loop[torch.arange(B) != 2] > 0.0).all())
    if case == "no_steps":
        assert torch.equal(loop, torch.zeros(B, dtype=dtype))
    if case == "lanes_settle_at_different_steps":
        hist = lipschitz.power_history_reference(Q, v0, n_iter)
        settled = (hist[1:] - hist[:-1]).abs() < tol
        first = {int(torch.nonzero(settled[:, b])[0]) for b in range(B)}
        assert len(first) > 2  # the slow lanes settle steps after the spiked ones


@pytest.mark.parametrize("rows,tol,want", [
    ([[1.0, 2.0], [1.5, 2.0], [1.5, 2.0]], 0.1, 3),  # a lane moves before each step: the cap
    ([[1.0, 2.0], [1.0, 2.0], [1.0, 2.0]], 0.1, 2),  # no lane moved in step 2
    ([[1.0, 2.0], [1.0, 2.0]], float("nan"), 0),  # nothing compares true: no step at all
    ([[float("nan"), 2.0], [float("nan"), 2.0]], 0.1, 2),  # NaN does not move
])
def test_stop_step_is_the_loops_rule(rows, tol, want):
    hist = torch.tensor(rows)
    K, Ls = lipschitz.stop_step(hist, tol)
    assert int(K) == want
    assert torch.equal(Ls[0], torch.zeros(2)) and _same(Ls[1:], hist)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 13])
def test_each_row_of_the_twins_history_is_the_loop_after_that_many_steps(k, dtype):
    """Row k − 1 of the history is the loop's L after k steps (tol 0: no
    stop), so a history held to the twin's row by row, as the kernel's is
    on the card, is held to the loop at every step."""
    Q, v0 = _grams(dtype, spiked=range(6))
    hist = lipschitz.power_history_reference(Q, v0, 13)
    assert hist.shape == (13, B)
    assert _same(hist[k - 1], F._power_loop(Q, v0, k, 0.0))


@pytest.mark.parametrize("is_cuda,dtype,n,want", [
    (False, torch.float32, 256, False),  # a CPU tensor: the loop
    (True, torch.float64, 256, False),  # float64: the loop
    (True, torch.float16, 256, False),
    (True, torch.float32, 1, True),
    (True, torch.float32, 256, True),
    (True, torch.float32, 664, True),  # the window's top
    (True, torch.float32, 665, False),  # past it: the loop
    (True, torch.float32, 1016, False),
])
def test_the_estimate_takes_the_kernel_on_cuda_float32_in_its_window(monkeypatch, is_cuda,
                                                                      dtype, n, want):
    """``_power_on_kernel`` asks the C export only for a CUDA float32 Q and
    follows its answer (a stand-in with the export's window here: no card;
    the export itself is held on the card)."""
    asked = []
    monkeypatch.setattr(lipschitz, "cluster_size",
                        lambda width: asked.append(width) or (4 if 1 <= width <= 664 else 0))
    Q = SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=(n, n, 3))
    assert F._power_on_kernel(Q) is want
    assert asked == ([n] if is_cuda and dtype == torch.float32 else [])


def test_a_cpu_precompute_never_loads_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU precompute loaded the kernel library")

    monkeypatch.setattr(_build, "library", refuse)
    g = torch.Generator().manual_seed(1)
    A, b = torch.randn((6, 20, 9), generator=g), torch.randn((6, 20), generator=g)
    gb = F.make_gram_batch(A, b, 0.1, 0.0)
    assert bool(torch.isfinite(gb.L).all()) and profiling.counters()["power_steps"] > 0


def test_the_one_read_path_spans_one_sync(monkeypatch):
    """``make_gram_batch`` through ``lipschitz.power_L`` (the twin, standing in
    for the kernel on a CPU tensor): ``fos.lipschitz`` holds one ``fos.sync``,
    ``power_steps`` is the step the loop stops at, and L is the loop's."""
    g = torch.Generator().manual_seed(2)
    A = torch.randn((B, M, N), generator=g) + 2.0 * torch.randn((B, M, 1), generator=g)
    b = torch.randn((B, M), generator=g)
    kw = dict(power_tol=1e-3)
    loop, k_loop = _steps(lambda: F.make_gram_batch(A, b, 0.1, 0.2, **kw))
    monkeypatch.setattr(F, "_power_on_kernel", lambda Q: True)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    profiling.reset_counters()
    prof.start()
    try:
        one = F.make_gram_batch(A, b, 0.1, 0.2, **kw)
    finally:
        prof.stop()
    assert torch.equal(one.L, loop.L)
    assert profiling.counters()["power_steps"] == k_loop < 100
    rows = profiling.spans()
    lip = next(i for i, row in enumerate(rows) if row[1] == "fos.lipschitz")
    assert [row[1] for row in rows if row[2] == lip] == ["fos.sync"]
