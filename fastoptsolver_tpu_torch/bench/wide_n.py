"""Wide-n batched lasso throughput on the card (port of
``fastoptsolver_tpu/bench/wide_n.py``).

Per feature count, in one process on one card, on one batch made on the card
from a seed:

- the Gram build: the two build kernels (``make_gram_batch_fused``, n ≤ 118)
  and the torch precompute (``make_gram_batch``: einsum and a 100-step power
  iteration that reads Q from device memory every step);
- the read rate of the (n, n, B) Gram (a plain ``Q.sum()``, as the reference
  uses XLA's ``jnp.sum`` there, not a kernel) and of one einsum matvec;
- the torch driver's certified solve (``fista_gram_batch``): instances/s and
  effective Q-stream GB/s (one Q read per iteration and per gap check);
- the kernel engine ``plan_gram_solve`` picks on the same Gram
  (``fista_gram_vmem``): the burst engine (n ≤ 104), the resident engine
  (n ≤ 168, one launch) or the Q-streaming engine. ``q_passes`` counts the
  Q passes from device memory as the port's kernels read it (burst engine
  one per burst, its Q held in shared memory for the burst; resident one
  per solve; Q-streaming one per burst where its cluster kernel holds Q,
  n ≤ 660, else one per iteration and one per burst, the reference's TPU
  model; the re-layout's copy is not counted), and ``q_stream_gbps`` is
  ``q_passes`` over the solve time;
- the routed end-to-end call from raw ``(A, b)`` (``solve_lasso_batch``;
  in the resident window its build skips the power loop and the kernel
  estimates L itself).

B is sized to a device-memory budget for Q (default 2 GB) and rounded to 128
lanes: B = 54144 at n = 96, 30464 at 128, 7552 at 256. Times are CUDA-event
medians of ``reps`` calls after one warm call. One JSON line per n, with the
card's name and power limit. A device measurement: it raises without a CUDA
device.

Usage (repo root, on a machine with a GPU):
  python -m fastoptsolver_tpu_torch.bench.wide_n --n 96 128 256
  python -m fastoptsolver_tpu_torch.bench.wide_n --n 128 160 256 --backtracking
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch


def build_problems(generator: torch.Generator, B: int, m: int, n: int):
    """The reference's recipe (``wide_n._build_problems``) in the
    feature-leading layout, on ``generator``'s device: A ~ N(0, 1/n) of shape
    (n, m, B), a 10%-sparse x_true with N(0, 9) entries, b = A x_true + 0.1
    noise (m, B), α₁ = 0.1·‖Aᵀb‖∞ (B,). torch's generator gives other
    numbers than ``jax.random`` from the same seed."""
    dev = generator.device
    A = torch.randn((n, m, B), generator=generator, device=dev)
    A.div_(math.sqrt(n))
    keep = torch.rand((n, B), generator=generator, device=dev) < 0.1
    x_true = torch.where(keep, 3.0 * torch.randn((n, B), generator=generator,
                                                 device=dev), 0.0)
    b = 0.1 * torch.randn((m, B), generator=generator, device=dev)
    for k in range(n):  # b += A x_true, plane by plane: no (B, m, n) copy
        b.add_(A[k] * x_true[k])
    aty = torch.stack([(A[k] * b).sum(0) for k in range(n)])
    alpha1 = 0.1 * aty.abs().amax(0)
    return A, b, alpha1


def _timed(fn, reps: int):
    """(median ms over ``reps`` calls after one warm call, last result),
    each call timed with CUDA events."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2], out


def run_one(n: int, hbm_gb: float = 2.0, max_iter: int = 1000,
            check_every: int = 25, tol: float = 1e-6, reps: int = 3,
            seed: int = 0, backtracking: bool = False) -> dict:
    from ..batch import solve_lasso_batch
    from ..batch.fista_gram import BatchFISTAConfig, fista_gram_batch, make_gram_batch
    from ..kernels import qstream
    from ..kernels.fista_vmem import fista_gram_vmem, plan_gram_solve
    from ..kernels.gram_build import _auto_tiles, make_gram_batch_fused

    if not torch.cuda.is_available():
        raise RuntimeError("wide_n measures the card; no CUDA device is visible")
    dev = torch.device("cuda", torch.cuda.current_device())
    m = 2 * n
    B = max(int(hbm_gb * 1e9 / (n * n * 4)) // 128 * 128, 128)
    A, b, alpha1 = build_problems(torch.Generator(device=dev).manual_seed(seed), B, m, n)
    cfg = BatchFISTAConfig(max_iter=max_iter, check_every=check_every,
                           rel_gap_tol=tol, backtracking=backtracking)

    ms_build_torch, gb = _timed(lambda: make_gram_batch(
        A.permute(2, 1, 0), b.T, alpha1, 0.0,
        generator=torch.Generator(device=dev).manual_seed(0)), 1)
    try:
        _auto_tiles(n, m)
    except ValueError as e:
        ms_build, build_note = None, str(e)[:120]
    else:
        ms_build, gb = _timed(lambda: make_gram_batch_fused(A, b, alpha1, 0.0), reps)
        build_note = None
    gb = type(gb)(*(v.contiguous() for v in (gb.Q, gb.c, gb.btb, gb.alpha1,
                                             gb.alpha2, gb.L)))
    q_bytes = gb.Q.numel() * 4.0
    ms_read, _ = _timed(lambda: gb.Q.sum(), reps)
    Y0 = torch.ones((n, B), device=dev)
    ms_mv, _ = _timed(lambda: torch.einsum("ijb,jb->ib", gb.Q, Y0), reps)
    read_gbps = q_bytes / ms_read / 1e6

    ms_d, res_d = _timed(lambda: fista_gram_batch(gb, cfg), reps)
    conv_d = int(res_d.converged.sum())
    it_d = int(res_d.n_iters_total)
    drv_bytes = (it_d + -(-it_d // check_every)) * q_bytes
    out = {
        "device": torch.cuda.get_device_name(dev), "power_limit": _power_limit(),
        "n": n, "m": m, "B": B, "backtracking": backtracking,
        "q_gb": q_bytes / 1e9,
        "build_kernel_ms": ms_build, "build_kernel_skipped": build_note,
        "build_torch_ms": ms_build_torch,
        "q_read_gbps": read_gbps, "matvec_gbps": q_bytes / ms_mv / 1e6,
        "driver": {"solve_ms": ms_d, "converged": conv_d,
                   "inst_per_s": conv_d / ms_d * 1e3, "iters_total": it_d,
                   "eff_q_stream_gbps": drv_bytes / ms_d / 1e6,
                   "pct_of_q_read": 100.0 * drv_bytes / ms_d / 1e6 / read_gbps},
    }
    try:
        engine = plan_gram_solve(n, cfg)[0]
    except (ValueError, NotImplementedError) as e:
        out["kernel"] = {"skipped": str(e)[:120]}
    else:
        ms_k, res_k = _timed(lambda: fista_gram_vmem(gb, cfg), reps)
        conv_k = int(res_k.converged.sum())
        it_k = int(res_k.n_iters_total)
        bursts = -(-it_k // check_every)
        held = engine != "qstream" or qstream.cluster_size(n) > 0
        q_passes = 1 if engine == "resident" else (bursts if held else it_k + bursts)
        out["kernel"] = {"engine": engine, "solve_ms": ms_k, "converged": conv_k,
                         "inst_per_s": conv_k / ms_k * 1e3, "iters_total": it_k,
                         "q_passes": q_passes,
                         "q_stream_gbps": q_passes * q_bytes / ms_k / 1e6,
                         "speedup_vs_driver": ms_d / ms_k}
    del gb
    ms_r, res_r = _timed(lambda: solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg,
                                                   feature_major=True), reps)
    conv_r = int(res_r.converged.sum())
    out["routed_end_to_end"] = {
        "total_ms": ms_r, "converged": conv_r, "inst_per_s": conv_r / ms_r * 1e3,
        "vs_build_plus_driver": ((ms_build or ms_build_torch) + ms_d) / ms_r,
    }
    return out


def _power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[96, 128, 256, 512])
    ap.add_argument("--hbm-gb", type=float, default=2.0,
                    help="device-memory budget for the Gram tensor (sizes B)")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--check-every", type=int, default=25)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backtracking", action="store_true",
                    help="the reference's Armijo search on every arm")
    args = ap.parse_args(argv)
    import fastoptsolver_tpu_torch  # noqa: F401  (numerics contract: no TF32)

    for n in args.n:
        print(json.dumps(run_one(n, args.hbm_gb, args.max_iter, args.check_every,
                                 args.tol, args.reps,
                                 backtracking=args.backtracking)), flush=True)


if __name__ == "__main__":
    main()
