"""The port's headline benchmark module (``bench/headline.py``) on the CPU:
its data recipe, its interleaved measurement loop (with the card's timers
replaced by stand-ins) and its JSON record. The timing itself needs the card
(``python -m fastoptsolver_tpu_torch.bench.headline``); without one the entry
raises.
"""
import json

import pytest
import torch

from fastoptsolver_tpu_torch.bench import headline
from fastoptsolver_tpu_torch.bench import stream
from fastoptsolver_tpu_torch.problems import generate_scenario_batch_fm

torch.set_num_threads(1)

B, M = 256, 1000


def _recipe(batch, m, device):
    """The bench data as chip_smoke.py made it before the headline module
    held the recipe (kept here as the bits to match)."""
    g = torch.Generator(device=device).manual_seed(0)
    pick = lambda vals: torch.tensor(vals, device=device)[
        torch.randint(len(vals), (batch,), generator=g, device=device)]
    noise, rho1, rho2 = pick([0.5, 1.0, 2.0, 5.0]), pick([0.5, 0.8]), pick([0.7, 0.9])
    A, b, _ = generate_scenario_batch_fm(g, batch, m=m, noise_std=noise, rho1=rho1, rho2=rho2)
    mu = A.mean(dim=1, keepdim=True)
    sd = A.std(dim=1, keepdim=True, unbiased=False)
    A.sub_(mu).div_(sd)
    alpha1 = 0.1 * torch.stack([(A[k] * b).sum(0) for k in range(A.shape[0])]).abs().amax(0)
    return A, b, alpha1


@pytest.fixture(scope="module")
def problem():
    return headline.build_problems(torch.Generator().manual_seed(0), B, M)


def test_build_problems_follows_the_recipe(problem):
    A, b, alpha1 = problem
    assert A.shape == (5, M, B) and b.shape == (M, B) and alpha1.shape == (B,)
    # standardised columns: each (feature, instance) has mean 0 and std 1 over rows
    assert float(A.double().mean(dim=1).abs().max()) < 1e-5
    assert float((A.double().std(dim=1, unbiased=False) - 1.0).abs().max()) < 1e-5
    aty = torch.einsum("nmb,mb->nb", A.double(), b.double())
    torch.testing.assert_close(alpha1.double(), 0.1 * aty.abs().amax(0), rtol=1e-5, atol=0)


def test_build_problems_is_chip_smokes_recipe_bit_for_bit(problem):
    for x, y in zip(problem, _recipe(B, M, "cpu")):
        assert torch.equal(x, y)


def _fake_meas(n_conv=B):
    class Res:
        n_iters_total = torch.tensor(100)
        iters = torch.full((B,), 50, dtype=torch.int32)
    return {"trial_ms": [[3.0, 2.0], [2.5, 2.5], [4.0, 1.0]], "ceilings_gbps": [2900.0, 3000.0],
            "beside_ms": [], "converged": n_conv, "failed": 0, "result": Res()}


def test_record_counts_bytes_without_a_tpu_constant():
    rec = headline.record((5, M, B), _fake_meas(), kernel_ms=2.0, device="card",
                          power_limit="card, 700.00 W")
    d = rec["detail"]
    assert rec["metric"] == "batched_lasso_instances_solved_to_1e-6_rel_gap_per_s"
    assert d["bytes_out"] == (5 + 3) * B * 4
    assert d["bytes_in"] == (5 * M + M) * B * 4
    assert d["solve_s"] == pytest.approx(2.5e-3)  # the best trial's mean
    assert rec["value"] == pytest.approx(B / 2.5e-3)
    assert d["stream_ceiling_gbps"] == 3000.0
    assert d["pct_of_achievable"] == pytest.approx(100 * d["bytes_in"] / 2.5e-3 / 1e9 / 3000.0)
    assert d["host_setup_ms"] == pytest.approx(0.5)
    assert d["trial_ms"] == [[3.0, 2.0], [2.5, 2.5], [4.0, 1.0]]
    # the TPU's 819 GB/s paper peak and the share against it are gone
    assert "roofline_pct" not in d and 819.0 not in d.values()
    json.dumps(rec)


def test_measure_interleaves_the_ceiling_with_the_solves(problem, monkeypatch):
    """Per trial: one ceiling measurement, the side call, then the solves,
    each timed alone (the card's timers replaced by stand-ins)."""
    A, b, alpha1 = problem
    calls = []
    monkeypatch.setattr(stream, "measure_stream_ceiling", lambda A, b, reps, trials: (
        calls.append(("ceiling", reps)), {"stream_ceiling_gbps": 1.0})[1])
    monkeypatch.setattr(headline, "_event_ms", lambda fn: (calls.append("timed"), (1.0, fn()))[1])
    meas = headline.measure(A, b, alpha1, headline.bench_config(), reps=2, trials=2,
                            ceiling_reps=3, beside=lambda: calls.append("beside"))
    one = [("ceiling", 3), "timed", "beside", "timed", "timed"]
    assert calls == one + one
    assert meas["trial_ms"] == [[1.0, 1.0], [1.0, 1.0]] and meas["beside_ms"] == [1.0, 1.0]
    assert meas["converged"] == B and meas["failed"] == 0


def test_headline_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main()
