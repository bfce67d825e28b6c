"""The port's A/B harness (``bench/ablate.py``) on the CPU, where every
engine runs its plain twin, held against the JAX package.

Tolerances: the routed record's ``converged`` and iteration statistics equal
the JAX driver's (``solve_lasso_batch(backend="xla")``) on the same f32
instances; the ``gap1`` proxy to 5e-7 absolute of JAX's (one 25-step burst:
differences at the f32 gap's rounding, 2e-7 here), the same lanes above
1e-5; the ``gap1`` sort, un-permuted, gives the
unsorted run's record exactly; ``_permute`` and its inverse give the Gram
back bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.batch import solve_lasso_batch as jax_solve_lasso_batch
from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
from fastoptsolver_tpu.batch.fista_gram import GramBatch as JaxGramBatch
from fastoptsolver_tpu.bench import ablate as jax_ablate
from fastoptsolver_tpu_torch import problems
from fastoptsolver_tpu_torch.bench import ablate, headline
from fastoptsolver_tpu_torch.kernels import make_gram_batch_fused

torch.set_num_threads(1)

ARGS = ["--batch", "64", "--m", "200", "--reps", "1", "--trials", "2", "--device", "cpu"]
# the reference's record keys (fastoptsolver_tpu/bench/ablate.py:286-302) less its
# TPU tiling knobs, with every trial's ms beside the best
KEYS = {"mode", "sort", "check_every", "pl_iters", "batch", "converged", "ms",
        "inst_per_s_M", "trial_ms"}
ITER_KEYS = {"iters_median", "iters_mean", "iters_max"}


def _records(*argv):
    return {r["mode"]: r for r in ablate.main([*ARGS, *argv])}


@pytest.mark.parametrize("modes", ["routed,fused1,fused1-plain", "burst,greedy,delta",
                                   "build-only,driver,adaptive"])
def test_main_runs_every_mode(modes, capsys):
    recs = _records("--mode", modes)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(recs) == len(modes.split(","))
    for mode, rec in recs.items():
        want = KEYS if mode == "build-only" else KEYS | ITER_KEYS
        assert set(rec) == want, mode
        assert len(rec["trial_ms"]) == 2 and rec["ms"] == min(rec["trial_ms"])
        assert rec["batch"] == 64 and rec["converged"] == 64, (mode, rec["converged"])
    if "fused1" in recs:  # one launch serves both of the reference's variants
        for k in ITER_KEYS:
            assert recs["fused1"][k] == recs["fused1-plain"][k]


def test_routed_record_matches_the_jax_driver():
    """The routed record on the port's data against the JAX driver on the
    same f32 instances: certified count and iteration statistics equal."""
    rec = _records("--mode", "routed")["routed"]
    A, b, a1 = ablate._build(64, 200, torch.device("cpu"))
    cfg = JaxConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    res = jax_solve_lasso_batch(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()),
                                jnp.asarray(a1.numpy()), 0.0, cfg=cfg, backend="xla",
                                feature_major=True)
    it = np.asarray(res.iters)
    assert rec["converged"] == int(np.sum(np.asarray(res.converged)))
    assert rec["iters_median"] == int(np.median(it))
    assert rec["iters_max"] == int(it.max())
    np.testing.assert_allclose(rec["iters_mean"], float(it.mean()), rtol=1e-12)


def test_gap1_sort_unpermutes_to_the_unsorted_record():
    plain = _records("--mode", "adaptive")["adaptive"]
    for sort in ("gap1", "L", "alpha"):
        rec = _records("--mode", "adaptive", "--sort", sort)["adaptive"]
        assert rec["sort"] == sort
        for k in ("converged", *ITER_KEYS):
            assert rec[k] == plain[k], (sort, k)


def test_gap_after_one_burst_matches_jax():
    A, b, a1 = ablate._build(64, 200, torch.device("cpu"))
    gb = make_gram_batch_fused(A, b, a1, 0.0)
    gbj = JaxGramBatch(**{f.name: jnp.asarray(getattr(gb, f.name).numpy())
                          for f in dataclasses.fields(gb)})
    got = ablate._gap_after_one_burst(gb, chunk=25, interpret=True)
    want = np.asarray(jax_ablate._gap_after_one_burst(gbj, chunk=25, interpret=True))
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-7)
    hard = want > 1e-5  # the lanes the proxy sorts last
    assert hard.sum() > 5 and np.array_equal(got.numpy() > 1e-5, hard)


def test_permute_and_its_inverse_give_the_gram_back():
    A, b, a1 = ablate._build(64, 200, torch.device("cpu"))
    gb = make_gram_batch_fused(A, b, a1, 0.0)
    order = torch.argsort(gb.L)
    perm = ablate._permute(gb, order)
    assert torch.equal(perm.L, torch.sort(gb.L).values)
    assert torch.equal(perm.Q[..., 3], gb.Q[..., int(order[3])])
    back = ablate._permute(perm, torch.argsort(order))
    for f in dataclasses.fields(gb):
        assert torch.equal(getattr(back, f.name), getattr(gb, f.name)), f.name


def test_build_problems_sorted_sorts_the_noise(monkeypatch):
    """The sorted build draws the same noise levels and ρ as the bench's
    build from the same seed, with the noise sorted."""
    seen = []
    real = problems.generate_scenario_batch_fm

    def spy(*args, **kw):
        seen.append({k: kw[k].clone() for k in ("noise_std", "rho1", "rho2")})
        return real(*args, **kw)

    monkeypatch.setattr(problems, "generate_scenario_batch_fm", spy)
    gen = lambda: torch.Generator().manual_seed(0)
    headline.build_problems(gen(), 64, 50)
    A, b, a1 = ablate._build_problems_sorted(gen(), 64, 50)
    plain, srt = seen
    assert torch.equal(srt["noise_std"], torch.sort(plain["noise_std"]).values)
    assert not torch.equal(plain["noise_std"], srt["noise_std"])
    for k in ("rho1", "rho2"):
        assert torch.equal(srt[k], plain[k])
    assert A.shape == (5, 50, 64) and b.shape == (50, 64) and a1.shape == (64,)


def test_unknown_mode_is_refused():
    with pytest.raises(SystemExit, match="unknown mode"):
        ablate.main([*ARGS, "--mode", "burst,bogus"])
