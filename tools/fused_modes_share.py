"""Certified share of the fused engine in each momentum mode on the bench
recipe, in the JAX reference and in the port's plain twin, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/fused_modes_share.py --batch 2048

The data follow ``bench.py:_build_problems`` in numpy (per-instance noise and
correlations from the reference grid, features standardised per instance,
α₁ = 0.1·‖Aᵀb‖∞), n=5, m=1000, at the bench config (check_every=25,
rel_gap_tol=1e-6, max_iter=1000). For each mode it prints one line: the
share of lanes each package certifies, lanes failed, and the median and
largest ``iters``. ``chip_smoke.py`` phase 9 holds the kernel's share in
restart and greedy mode at the reference's, less one point.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

MODES = {
    "restart": dict(adaptive_restart=True),
    "greedy": dict(momentum="greedy"),
    "armijo": dict(backtracking=True),
    "armijo_restart": dict(backtracking=True, adaptive_restart=True),
}
X_TRUE = (-2.0, 1.0, 0.1, 0.01, 3.0)


def bench_inputs(batch: int, m: int = 1000, seed: int = 0):
    """bench.py:_build_problems in numpy, feature-leading float32."""
    rng = np.random.default_rng(seed)
    noise = rng.choice([0.5, 1.0, 2.0, 5.0], batch)
    rho1, rho2 = rng.choice([0.5, 0.8], batch), rng.choice([0.7, 0.9], batch)

    def block(mean, rho, scale):
        z = rng.normal(size=(2, m, batch))
        c1 = rho * z[0] + np.sqrt(1 - rho * rho) * z[1]
        return np.stack([z[0], c1]) * np.sqrt(scale) + np.asarray(mean)[:, None, None]

    A = np.concatenate([block((6.0, 0.2), rho1, 0.25), block((300.0, 60.0), rho2, 100.0),
                        4.0 + rng.normal(size=(1, m, batch))])
    b = np.einsum("nmb,n->mb", A, np.asarray(X_TRUE)) + noise * rng.normal(size=(m, batch))
    A = (A - A.mean(axis=1, keepdims=True)) / A.std(axis=1, keepdims=True)
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(A), f32(b), f32(a1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=list(MODES))
    args = ap.parse_args()

    import jax.numpy as jnp
    import torch

    from fastoptsolver_tpu.batch.fista_gram import BatchFISTAConfig as JaxConfig
    from fastoptsolver_tpu.kernels import solve_lasso_fused as jax_fused
    from fastoptsolver_tpu_torch import convert
    from fastoptsolver_tpu_torch.kernels import fused_solve

    A, b, a1 = bench_inputs(args.batch)
    B = args.batch
    for mode in args.modes:
        cfg = JaxConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6, **MODES[mode])
        t0 = time.perf_counter()
        rj = jax_fused(jnp.asarray(A), jnp.asarray(b), jnp.asarray(a1), 0.0, cfg=cfg,
                       b_tile=128, interpret=True)
        conv_j = np.asarray(rj.converged)
        t1 = time.perf_counter()
        rt = fused_solve.solve_lasso_fused(
            torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(a1), 0.0,
            cfg=convert.config_from_jax(cfg), b_tile=128, interpret=True)
        t2 = time.perf_counter()
        it_j, it_t = np.asarray(rj.iters), rt.iters.numpy()
        print(f"{mode}: B={B} | JAX reference certified {conv_j.sum()}/{B} "
              f"({100.0 * conv_j.mean():.2f}%), failed {int(np.asarray(rj.failed).sum())}, "
              f"iters median {int(np.median(it_j))} max {int(it_j.max())} ({t1 - t0:.1f} s) | "
              f"port twin certified {int(rt.converged.sum())}/{B} "
              f"({100.0 * float(rt.converged.double().mean()):.2f}%), failed "
              f"{int(rt.failed.sum())}, iters median {int(np.median(it_t))} max "
              f"{int(it_t.max())} ({t2 - t1:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
