"""The port's 80-scenario sweep (``fastoptsolver_tpu_torch.bench.sweep``)
against the JAX package's (``fastoptsolver_tpu.bench.sweep``), on the CPU.

Tolerances:
- ``build_scenarios``: the same NumPy bits.
- ``run_sweep`` at ``tests/test_sweep.py``'s slice (m = 200, 60 iterations,
  2 scenarios, float64) with one L in both packages (``batch_lipschitz``
  patched in both sweep modules to the exact λ_max + α₂): fixed-step and
  L-BFGS histories to rtol 1e-9 over every iteration, Armijo histories over
  their first 8 (past ~10 the accept/reject is decided by the last bits;
  ROADMAP "Not faults"). Measured: ≤ 4e-16 on every history's first 8
  iterations, ≤ 5.1e-12 over all 60.
- Unpatched, each package's own power iteration (a torch generator against
  ``jax.random``; the loop stops once |ΔL| < 1e-6): every history within
  1e-5 relative (measured 7.5e-8, the Armijo t2.0 runs; 6.5e-12 fixed step).
- The full 80 scenarios at 130 iterations: ``tests/test_sweep.py``'s figure
  envelopes and its reach sets against the NumPy oracle of the reference
  recurrence (``tests/oracle_np.py``), on the port's own histories.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastoptsolver_tpu.bench import sweep as J
from fastoptsolver_tpu_torch import bench as T_bench
from fastoptsolver_tpu_torch.bench import sweep as T
from oracle_np import fista_np, ista_np

torch.set_num_threads(1)

PORT = Path(T_bench.__file__).resolve().parents[1]
SLICE = dict(m=200, max_iter=60, limit=2)
SUMMARY_KEYS = {"scenarios", "solver_runs", "solve_s", "runs_per_s",
                "final_suboptimality_median"}


def _exact_L(A: np.ndarray, alpha2: np.ndarray) -> np.ndarray:
    lam = np.linalg.eigvalsh(np.einsum("bmi,bmj->bij", A, A)).max(axis=1)
    return lam + alpha2


def _jax_exact_L(pb, *args, **kw):
    return jnp.asarray(_exact_L(np.asarray(pb.A), np.asarray(pb.alpha2)))


def _torch_exact_L(pb, *args, **kw):
    L = _exact_L(pb.A.numpy(), pb.alpha2.numpy())
    return torch.as_tensor(L, dtype=pb.A.dtype)


@pytest.fixture(scope="module")
def slice_runs():
    """Both packages' slice, with the shared exact L and with their own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "batch_lipschitz", _jax_exact_L)
        mp.setattr(T, "batch_lipschitz", _torch_exact_L)
        shared = (J.run_sweep(dtype=jnp.float64, **SLICE),
                  T.run_sweep(dtype=torch.float64, device="cpu", **SLICE))
    own = (J.run_sweep(dtype=jnp.float64, **SLICE),
           T.run_sweep(dtype=torch.float64, device="cpu", **SLICE))
    return dict(shared=shared, own=own)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / np.abs(b)).max())


def test_build_scenarios_is_the_references_bits():
    grid_j, data_j = J.build_scenarios(m=1000)
    grid_t, data_t = T.build_scenarios(m=1000)
    assert grid_t == grid_j and len(grid_t) == 80
    for (Aj, bj), (At, bt) in zip(data_j, data_t):
        assert isinstance(At, np.ndarray) and At.dtype == np.float64
        assert np.array_equal(At, np.asarray(Aj)) and np.array_equal(bt, np.asarray(bj))
    _, raw_j = J.build_scenarios(m=300, limit=3, standardize=False)
    _, raw_t = T.build_scenarios(m=300, limit=3, standardize=False)
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(raw_j, raw_t))


def test_constants_are_the_references():
    assert (T.ALPHA1, T.ALPHA2, T.DELTA) == (J.ALPHA1, J.ALPHA2, J.DELTA)
    assert T.VARIANTS == J.VARIANTS


def test_same_keys_and_shapes_as_jax(slice_runs):
    (gj, rj), (gt, rt) = slice_runs["shared"]
    assert gt == gj
    assert {s: set(v) for s, v in rt.items()} == {s: set(v) for s, v in rj.items()}
    for s in rj:
        for v in rj[s]:
            assert isinstance(rt[s][v], np.ndarray)
            assert rt[s][v].shape == np.asarray(rj[s][v]).shape == (2, 60)


@pytest.mark.parametrize("solver", ["ista", "fista", "fista_delta", "lbfgs"])
def test_histories_match_jax_with_a_shared_L(slice_runs, solver):
    (_, rj), (_, rt) = slice_runs["shared"]
    for name, hj in rj[solver].items():
        hj = np.asarray(hj)
        if "armijo" in name:
            assert _rel(rt[solver][name][:, :8], hj[:, :8]) <= 1e-9, name
        else:
            assert _rel(rt[solver][name], hj) <= 1e-9, name


def test_histories_match_jax_with_each_packages_own_L(slice_runs):
    """Measured 7.5e-8 (the Armijo t2.0 histories; fixed step 6.5e-12):
    the two power iterations' L agree to their stopping tolerance."""
    (_, rj), (_, rt) = slice_runs["own"]
    worst = max(_rel(rt[s][v], np.asarray(h)) for s in rj for v, h in rj[s].items())
    assert worst <= 1e-5


def test_suboptimality_equals_jax(slice_runs):
    (_, rj), (_, rt) = slice_runs["shared"]
    sub_t, sub_j = T.suboptimality(rt), J.suboptimality(rt)
    assert sub_t.keys() == sub_j.keys()
    for s in sub_j:
        for v in sub_j[s]:
            assert np.array_equal(sub_t[s][v], np.asarray(sub_j[s][v]))
    # and, as tests/test_sweep.py reads the slice: ≥ 0 up to float noise, falling
    for solver in ("ista", "fista", "fista_delta"):
        for curves in sub_t[solver].values():
            assert curves.min() >= -1e-6
            assert np.median(curves[:, -1]) <= np.median(curves[:, 0])


def test_plot_scenario_writes_the_reference_file_name(slice_runs, tmp_path):
    pytest.importorskip("matplotlib")
    (grid, _), (_, rt) = slice_runs["shared"]
    sub = T.suboptimality(rt)
    base = T.plot_scenario(0, grid[0], sub, str(tmp_path), fmt=("png", "pdf"))
    s, n, r1, r2 = grid[0]
    assert base == os.path.join(str(tmp_path), f"benchmark_s{s}_n{n}_r1{r1}_r2{r2}")
    assert os.path.exists(f"{base}.png") and os.path.exists(f"{base}.pdf")


@pytest.mark.parametrize("figures", [False, True])
def test_main_prints_one_json_line_with_the_reference_keys(capsys, tmp_path, figures):
    argv = ["--device", "cpu", "--m", "200", "--max-iter", "20", "--limit", "2"]
    if figures:
        pytest.importorskip("matplotlib")
        argv += ["--out", str(tmp_path)]
    else:
        argv += ["--no-figures"]
    T.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == SUMMARY_KEYS | ({"figures", "plot_s"} if figures else set())
    assert rec["scenarios"] == 2 and rec["solver_runs"] == 2 * 19
    assert set(rec["final_suboptimality_median"]) == {"ista", "fista", "fista_delta", "lbfgs"}
    if figures:
        assert rec["figures"] == 2 and len(list(tmp_path.glob("benchmark_*.png"))) == 2


def test_no_card_no_run(monkeypatch):
    """Without a card the sweep raises unless the caller asks for the CPU:
    ``run_sweep()`` and the CLI's default ``--device cuda``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_sweep(m=50, max_iter=5, limit=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--no-figures", "--limit", "1", "--m", "50", "--max-iter", "5"])


def test_bench_exports_the_reference_names_without_matplotlib():
    from fastoptsolver_tpu import bench as J_bench

    assert T_bench.__all__ == J_bench.__all__
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from fastoptsolver_tpu_torch.bench import run_sweep, suboptimality, plot_scenario, build_scenarios
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# --- the full 80-scenario grid, as tests/test_sweep.py holds the reference ---


def _iters_to(curves, thr):
    hit = curves <= thr
    return np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, np.inf)


@pytest.fixture(scope="module")
def full_sweep():
    grid, results = T.run_sweep(m=1000, max_iter=130, limit=None, dtype=torch.float64,
                                device="cpu")
    return grid, results, T.suboptimality(results)


def test_figure_envelopes_all_80_scenarios(full_sweep):
    """``tests/test_sweep.py::test_figure_envelopes_all_80_scenarios`` on the
    port's histories: L-BFGS ≤ 1e-7 by iteration 13, fixed-step FISTA and
    FISTA-Δ ≤ 1e-4 by 70, ISTA by 120, Armijo FISTA's reaching scenarios at
    FISTA-like speed, FISTA's median below ISTA's."""
    grid, results, sub = full_sweep
    assert len(grid) == 80
    it = _iters_to(sub["lbfgs"]["ridge"], 1e-7)
    assert np.isfinite(it).all()
    assert it.max() <= 13 and np.median(it) >= 8
    for reg in ("lasso", "enet"):
        for solver, hi in (("fista", 70), ("fista_delta", 70)):
            it = _iters_to(sub[solver][f"{reg}-fixed-t1.0"], 1e-4)
            assert np.isfinite(it).all(), (solver, reg)
            assert it.max() <= hi, (solver, reg, it.max())
            assert 20 <= np.median(it) <= 70, (solver, reg, np.median(it))
        for variant in (f"{reg}-fixed-t1.0", f"{reg}-armijo-t1.0"):
            it = _iters_to(sub["ista"][variant], 1e-4)
            assert np.isfinite(it).all(), variant
            assert it.max() <= 120, (variant, it.max())
            assert 30 <= np.median(it) <= 120, (variant, np.median(it))
        for solver in ("fista", "fista_delta"):
            for tf in ("t1.0", "t2.0"):
                it = _iters_to(sub[solver][f"{reg}-armijo-{tf}"], 1e-4)
                reached = np.isfinite(it)
                assert np.median(it[reached]) <= 70, (solver, reg, tf)
    it_f = _iters_to(sub["fista"]["lasso-fixed-t1.0"], 1e-4)
    it_i = _iters_to(sub["ista"]["lasso-fixed-t1.0"], 1e-4)
    assert np.median(it_f) < np.median(it_i)


def test_armijo_stall_matches_reference_oracle(full_sweep):
    """``tests/test_sweep.py::test_armijo_stall_matches_reference_oracle`` on
    the port's histories: which scenarios' Armijo runs reach 1e-4 (under the
    sweep's f* convention) agrees with the NumPy oracle of the reference
    recurrence, with the exact λ_max for L, on ≥ 90% of scenario-runs, and
    where both reach they reach at the same speed."""
    grid, results, sub = full_sweep
    _, data = T.build_scenarios(m=1000, limit=None)
    max_iter = next(iter(results["fista"].values())).shape[1]
    f_star = {}
    for reg in ("lasso", "enet"):
        best = np.full(len(grid), np.inf)
        for solver in ("ista", "fista", "fista_delta"):
            for name, objs in results[solver].items():
                if name.startswith(reg):
                    best = np.minimum(best, objs.min(axis=1))
        f_star[reg] = best
    checked = disagreements = 0
    for reg, a2 in (("lasso", 0.0), ("enet", T.ALPHA2)):
        for solver, delta in (("fista", None), ("fista_delta", 3.0), ("ista", "ista")):
            for tf in (1.0, 2.0):
                name = f"{reg}-armijo-t{tf}"
                it_port = _iters_to(sub[solver][name], 1e-4)
                curves = np.empty((len(grid), max_iter))
                for i, (A, b) in enumerate(data):
                    L = float(np.linalg.eigvalsh(A.T @ A).max()) + a2
                    if solver == "ista":
                        _, tr = ista_np(A, b, T.ALPHA1, a2, L, backtracking=True,
                                        t_init_factor=tf, max_iter=max_iter)
                    else:
                        _, tr = fista_np(A, b, T.ALPHA1, a2, L, backtracking=True,
                                         t_init_factor=tf, max_iter=max_iter, delta=delta)
                    curves[i] = np.asarray(tr["obj"])
                it_np = _iters_to(curves - f_star[reg][:, None], 1e-4)
                agree = np.isfinite(it_port) == np.isfinite(it_np)
                checked += len(grid)
                disagreements += int((~agree).sum())
                both = np.isfinite(it_port) & np.isfinite(it_np)
                assert np.median(np.abs(it_port[both] - it_np[both])) <= 2, (solver, name)
    assert disagreements / checked <= 0.1, (disagreements, checked)


def test_sweep_module_reads_no_matplotlib_at_import():
    """matplotlib is imported inside ``plot_scenario`` only (the card's
    machine has none)."""
    src = (PORT / "bench" / "sweep.py").read_text()
    top = [ln for ln in src.splitlines() if re.match(r"(import|from) ", ln)]
    assert not any("matplotlib" in ln for ln in top)
