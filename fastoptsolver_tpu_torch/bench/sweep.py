"""The reference benchmark sweep (port of ``fastoptsolver_tpu/bench/sweep.py``).

80 scenarios — seeds {0..4} × noise {0.5, 1.0, 2.0, 5.0} × ρ₁ {0.5, 0.8} ×
ρ₂ {0.7, 0.9} — and for each 1 L-BFGS config plus 6 variants each of ISTA /
FISTA / FISTA-Δ ({lasso, elasticnet} × {fixed-t1.0, armijo-t1.0,
armijo-t2.0}), then a 4-panel log-log suboptimality figure per scenario
(``figures/benchmark_s{seed}_n{noise}_r1{rho1}_r2{rho2}.png``).

For each (solver, variant) configuration the 80 scenarios are stacked and
solved in lockstep by ``batch.solve_batch`` (each step under
``torch.func.vmap``), so e.g. all 80 armijo-lasso FISTA runs are one batched
solve. Per-scenario ``f*`` is the best objective seen by any run on that
scenario/regularization (the reference's convention).

The sweep runs on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); without a card and without that
request it raises. The reference instead forces the CPU unless given
``--tpu``. The power iteration behind ``batch_lipschitz`` draws its start
vectors from a ``torch.Generator`` seeded with 0 on the batch's device, so
L agrees with the reference's to the loop's tolerance, not bit for bit.

CLI:
    python -m fastoptsolver_tpu_torch.bench.sweep --out figures --limit 4
    python -m fastoptsolver_tpu_torch.bench.sweep --no-figures   # data only
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..batch import batch_lipschitz, solve_batch, stack_problems
from ..problems import LeastSquares, generate_boston_like, scenario_grid
from ..problems.base import target_device
from ..solvers import FISTAConfig, ISTAConfig, fista_delta_config
from ..solvers.lbfgs import LBFGSConfig

# Default regularization weights for the sweep (the reference notebook's
# exact values are unrecoverable — the legends only name the reg type).
ALPHA1, ALPHA2 = 1.0, 0.5
DELTA = 3.0  # FISTA-Δ momentum parameter (must be > 2)

# The six first-order variants visible in the reference figure legends.
VARIANTS = [
    ("lasso-fixed-t1.0", "lasso", False, 1.0),
    ("lasso-armijo-t1.0", "lasso", True, 1.0),
    ("lasso-armijo-t2.0", "lasso", True, 2.0),
    ("enet-fixed-t1.0", "elasticnet", False, 1.0),
    ("enet-armijo-t1.0", "elasticnet", True, 1.0),
    ("enet-armijo-t2.0", "elasticnet", True, 2.0),
]


def build_scenarios(m: int = 1000, limit: int | None = None, standardize: bool = True):
    """Scenario data as NumPy float64, the reference's bits. Columns are
    standardized by default: the raw generator's feature scales (0.2 … 300)
    give cond(AᵀA) ~ 1e6 and fixed-step first-order methods crawl; the
    reference figures show convergence in tens of iterations, which implies
    its notebook normalized features too."""
    grid = scenario_grid()
    if limit:
        grid = grid[:limit]
    data = []
    for (s, n, r1, r2) in grid:
        A, b, _ = generate_boston_like(m, s, n, r1, r2)
        if standardize:
            A = (A - A.mean(0)) / A.std(0)
        data.append((A, b))
    return grid, data


def _stack(data, reg, dtype, device):
    return stack_problems(
        [LeastSquares.create(A, b, reg, ALPHA1, ALPHA2, dtype=dtype, device=device)
         for A, b in data]
    )


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def run_sweep(m: int = 1000, max_iter: int = 500, limit: int | None = None,
              dtype: torch.dtype = torch.float32, device=None):
    """Run every solver/variant over the (possibly limited) scenario grid on
    ``device`` (default: the card, raising without one).

    Returns ``(grid, results)`` where ``results[solver][variant]`` holds
    NumPy ``obj`` histories of shape (num_scenarios, max_iter) (L-BFGS: one
    entry keyed 'ridge').
    """
    device = target_device(device)
    grid, data = build_scenarios(m, limit)
    results: dict[str, dict[str, np.ndarray]] = {"ista": {}, "fista": {}, "fista_delta": {}, "lbfgs": {}}
    problems_by_reg = {reg: _stack(data, reg, dtype, device)
                       for reg in ("lasso", "elasticnet", "ridge")}
    Ls_by_reg = {
        reg: batch_lipschitz(problems_by_reg[reg]) for reg in ("lasso", "elasticnet")
    }

    for name, reg, bt, tf in VARIANTS:
        pb, Ls = problems_by_reg[reg], Ls_by_reg[reg]
        ista_cfg = ISTAConfig(max_iter=max_iter, backtracking=bt, t_init_factor=tf)
        fista_cfg = FISTAConfig(max_iter=max_iter, backtracking=bt, t_init_factor=tf)
        delta_cfg = fista_delta_config(
            DELTA, max_iter=max_iter, backtracking=bt, t_init_factor=tf
        )
        results["ista"][name] = _numpy(
            solve_batch(pb, "ista", ista_cfg, history=True, L=Ls).history.obj
        )
        results["fista"][name] = _numpy(
            solve_batch(pb, "fista", fista_cfg, history=True, L=Ls).history.obj
        )
        results["fista_delta"][name] = _numpy(
            solve_batch(pb, "fista", delta_cfg, history=True, L=Ls).history.obj
        )

    # L-BFGS: ridge objective (the reference benchmarks one config; its lasso
    # quirk makes the lasso history non-comparable — SURVEY.md §7 item 7).
    lb = solve_batch(
        problems_by_reg["ridge"], "lbfgs", LBFGSConfig(max_iter=max_iter, tol=1e-10),
        history=True,
    )
    objs = _numpy(lb.history.obj)
    valid = _numpy(lb.history.valid)
    # pad frozen entries with the last valid objective so curves are flat
    objs = np.where(valid, objs, np.minimum.accumulate(objs, axis=1))
    results["lbfgs"]["ridge"] = objs
    return grid, results


def suboptimality(results):
    """Per scenario and regularization, subtract the best objective seen by
    any solver (the reference's f* convention)."""
    out = {s: {} for s in results}
    n_scen = next(iter(results["fista"].values())).shape[0]
    f_star = {}
    for reg in ("lasso", "enet"):
        best = np.full(n_scen, np.inf)
        for solver in ("ista", "fista", "fista_delta"):
            for name, objs in results[solver].items():
                if name.startswith(reg):
                    best = np.minimum(best, objs.min(axis=1))
        f_star[reg] = best
    f_star["ridge"] = results["lbfgs"]["ridge"].min(axis=1)
    for solver in ("ista", "fista", "fista_delta"):
        for name, objs in results[solver].items():
            reg = "lasso" if name.startswith("lasso") else "enet"
            out[solver][name] = objs - f_star[reg][:, None]
    out["lbfgs"]["ridge"] = results["lbfgs"]["ridge"] - f_star["ridge"][:, None]
    return out


def plot_scenario(idx, scen, subopt, out_dir, fmt=("png",)):
    """One 4-panel log-log figure, reference layout: L-BFGS | ISTA | FISTA |
    FISTA-Δ. matplotlib is imported here, so the module imports without it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s, n, r1, r2 = scen
    fig, axes = plt.subplots(1, 4, figsize=(22, 4.5), sharey=True)
    panels = [
        ("L-BFGS", "lbfgs"),
        ("ISTA", "ista"),
        ("FISTA", "fista"),
        ("FISTA-Δ", "fista_delta"),
    ]
    eps = 1e-16
    for ax, (title, solver) in zip(axes, panels):
        for name, curves in subopt[solver].items():
            y = np.maximum(curves[idx], eps)
            ax.loglog(np.arange(1, len(y) + 1), y, label=name, linewidth=1.2)
        ax.set_title(title)
        ax.set_xlabel("iteration")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=7)
    axes[0].set_ylabel("suboptimality  f(x_k) − f*")
    fig.suptitle(f"Scenario s{s}_n{n}_r1{r1}_r2{r2}")
    fig.tight_layout()
    base = os.path.join(out_dir, f"benchmark_s{s}_n{n}_r1{r1}_r2{r2}")
    for f in fmt:
        fig.savefig(f"{base}.{f}", dpi=110)
    plt.close(fig)
    return base


def summarize(grid, results, sub, solve_s: float) -> dict:
    """The CLI's JSON summary (the reference's keys) of a sweep that took
    ``solve_s`` seconds."""
    n_runs = sum(len(v) for v in results.values()) * len(grid)
    return {
        "scenarios": len(grid),
        "solver_runs": n_runs,
        "solve_s": round(solve_s, 2),
        "runs_per_s": round(n_runs / solve_s, 1),
        "final_suboptimality_median": {
            solver: float(np.median([c[:, -1] for c in curves.values()]))
            for solver, curves in sub.items()
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="figures")
    ap.add_argument("--limit", type=int, default=None, help="first N scenarios only")
    ap.add_argument("--m", type=int, default=1000)
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--no-figures", action="store_true")
    ap.add_argument("--pdf", action="store_true", help="also save PDFs like the reference")
    ap.add_argument(
        "--f32", action="store_true",
        help="solve in float32; default is float64 so the suboptimality "
        "curves resolve the reference's 1e-7 floors",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the solves run (default: the card; raises without one)",
    )
    args = ap.parse_args(argv)

    dtype = torch.float32 if args.f32 else torch.float64
    t0 = time.perf_counter()
    grid, results = run_sweep(args.m, args.max_iter, args.limit, dtype,
                              device=None if args.device == "cuda" else args.device)
    solve_s = time.perf_counter() - t0
    sub = suboptimality(results)
    summary = summarize(grid, results, sub, solve_s)
    if not args.no_figures:
        os.makedirs(args.out, exist_ok=True)
        fmt = ("png", "pdf") if args.pdf else ("png",)
        t0 = time.perf_counter()
        for i, scen in enumerate(grid):
            plot_scenario(i, scen, sub, args.out, fmt)
        summary["figures"] = len(grid)
        summary["plot_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
