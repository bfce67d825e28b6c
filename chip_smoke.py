"""Smoke run of the PyTorch/CUDA port (fastoptsolver_tpu_torch) on one GPU.

    python3 chip_smoke.py      # one H100; ~30 s including the nvcc build

Phases, one line each (``--`` lines are detail):

1. device — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build  — nvcc builds the kernels from ``kernels/csrc`` (seconds, registers);
3. kernel vs twin — each CUDA kernel against its plain PyTorch twin on the
   card: the fused solve at three small shapes (nesterov, and delta with
   α₂=0.3; x to rtol 1e-5/atol 1e-6, ``converged`` identical, ``iters``
   within ``check_every``), the stream pass (to 1e-5 of each lane's absolute
   sum), then both at the bench shape;
4. main path — ``solve_lasso_batch`` at the bench configuration (n=5,
   m=1000, float32, fixed Nesterov momentum, check_every=25, rel_gap_tol=1e-6,
   max_iter=1000) on data the ported generator makes on the card; every lane
   must certify, none may fail, and 4096 sampled lanes are rechecked in
   float64; then one read-ceiling measurement, the bench path's roofline;
5. times — CUDA events, median of 5 solves interleaved with the stream
   ceiling: solve ms and instances/s (every timed solve must certify every
   lane), ceiling GB/s, pct_of_achievable, the twin's time, iteration median
   and maximum.

Launch counts are set to 0 just before phase 4's solve and read just after
it: the fused kernel must have launched exactly once. The stream count is set
to 0 again just before phase 4's ceiling measurement and read just after it.
The script then prints the per-kernel JSON line (``ms`` is the kernel's own
launch time; the fused kernel's ``e2e_ms`` is the whole ``solve_lasso_batch``
call), the card's name and power limit, and, last, ``{"ok": true, "device":
{...}}``. It exits non-zero, printing no result, when there is no CUDA device
or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

FUSED_SRC = "fastoptsolver_tpu_torch/kernels/csrc/fused_solve.cu"
STREAM_SRC = "fastoptsolver_tpu_torch/kernels/csrc/stream.cu"
SMALL_SHAPES = ((5, 250, 390), (1, 64, 128), (8, 333, 300))
BATCH = 262144  # the bench configuration's instances (bench.py:88)


class PhaseFailed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median(xs):
    return sorted(xs)[len(xs) // 2]


def cuda_ms(fn, reps: int = 1):
    """(ms per call, last result) of ``fn`` timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def small_problem(n: int, m: int, B: int, seed: int, device):
    """Random lasso instances, feature-leading, made with numpy from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, B))
    for k in range(1, n):  # AR(1) features, ρ = 0.2: 25-50 iterations, and
        # conditioned so that f32 rounding moves x by < 1e-5 relative
        A[k] = 0.2 * A[k - 1] + np.sqrt(1 - 0.04) * A[k]
    A = A.astype(np.float32)
    xt = np.zeros((n, B), np.float32)
    xt[: max(n // 2, 1)] = rng.normal(size=(max(n // 2, 1), B))
    b = (np.einsum("nmb,nb->mb", A, xt)
         + 2.0 * rng.normal(size=(m, B))).astype(np.float32)
    a1 = 0.1 * np.abs(np.einsum("nmb,mb->nb", A, b)).max(axis=0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t(A), t(b), t(a1.astype(np.float32))


def bench_problem(batch: int, m: int, device):
    """The bench configuration's data (bench.py:_build_problems), made on the
    card by the ported generator: per-instance noise/ρ drawn from the
    reference grid, features standardised per instance, α₁ = 0.1·‖Aᵀb‖∞."""
    import torch

    from fastoptsolver_tpu_torch.problems import generate_scenario_batch_fm

    g = torch.Generator(device=device).manual_seed(0)
    pick = lambda vals: torch.tensor(vals, device=device)[
        torch.randint(len(vals), (batch,), generator=g, device=device)]
    noise, rho1, rho2 = pick([0.5, 1.0, 2.0, 5.0]), pick([0.5, 0.8]), pick([0.7, 0.9])
    A, b, _ = generate_scenario_batch_fm(g, batch, m=m, noise_std=noise,
                                         rho1=rho1, rho2=rho2)
    mu = A.mean(dim=1, keepdim=True)
    sd = A.std(dim=1, keepdim=True, unbiased=False)
    A.sub_(mu).div_(sd)
    alpha1 = 0.1 * torch.stack([(A[k] * b).sum(0) for k in range(A.shape[0])]).abs().amax(0)
    return A, b, alpha1


def compare_fused(res_k, res_t, check_every: int, label: str) -> float:
    import torch

    xk, xt = res_k.x.float(), res_t.x.float()
    err = float((xk - xt).abs().max())
    close = torch.allclose(xk, xt, rtol=1e-5, atol=1e-6)
    same_conv = bool(torch.equal(res_k.converged, res_t.converged))
    d_iters = int((res_k.iters.long() - res_t.iters.long()).abs().max())
    print(f"-- fused {label}: max|dx|={err:.3e} allclose={close} "
          f"converged_equal={same_conv} max|d_iters|={d_iters} "
          f"certified={int(res_k.converged.sum())}/{res_k.converged.numel()}")
    require(close and same_conv and d_iters <= check_every,
            f"fused kernel disagrees with its twin at {label}")
    return err


def objective64(A, b, alpha1, x, chunk: int = 16384):
    """Per-lane lasso objective ½‖Ax − b‖² + α₁‖x‖₁ in float64, by lane chunks."""
    import torch

    out = []
    for s in range(0, x.shape[0], chunk):
        sl = slice(s, s + chunk)
        r = torch.einsum("nmb,bn->mb", A[:, :, sl].double(), x[sl].double()) - b[:, sl].double()
        out.append(0.5 * (r * r).sum(0) + alpha1[sl].double() * x[sl].double().abs().sum(1))
    return torch.cat(out)


def compare_fused_bench(A, b, alpha1, res_k, res_t, check_every: int):
    """Kernel vs twin at the bench shape. The bench data are correlated
    (ρ up to 0.9), and there f32 rounding of the Gram alone moves x by up to
    ~5e-4 (the twin against itself with a float64-accumulated Gram:
    tests/test_torch_slice.py::test_gram_rounding_moves_x_on_bench_inputs),
    so x is reported and the objective is held: both
    sides certify a relative gap ≤ 1e-6, which bounds each objective to
    1e-6·max(f, 1) above the optimum; the check allows 1e-6 between them.
    ``iters`` is reported, not held: on a slowly converging lane the f32 gap
    can sit near the tolerance for several bursts, so the burst at which it
    first certifies moves with the rounding (the twin against itself, as
    above, moves it by a burst)."""
    import torch

    dx = float((res_k.x - res_t.x).abs().max())
    f_k = objective64(A, b, alpha1, res_k.x)
    f_t = objective64(A, b, alpha1, res_t.x)
    dobj = float(((f_k - f_t).abs() / f_t.clamp_min(1.0)).max())
    same_conv = bool(torch.equal(res_k.converged, res_t.converged))
    d_iters = (res_k.iters.long() - res_t.iters.long()).abs()
    print(f"-- fused bench {tuple(A.shape)}: max|dx|={dx:.3e} max rel|dobj|={dobj:.3e} "
          f"converged_equal={same_conv} max|d_iters|={int(d_iters.max())} "
          f"lanes with |d_iters| > {check_every}: {int((d_iters > check_every).sum())}")
    require(dobj <= 1e-6 and same_conv,
            "fused kernel disagrees with its twin at the bench shape")
    return dx, dobj


def compare_stream(A, b, label: str) -> float:
    import torch

    from fastoptsolver_tpu_torch.bench.stream import stream_pass, stream_pass_reference

    out_k = stream_pass(A, b)
    out_t = stream_pass_reference(A, b)
    scale = A.abs().sum(dim=(0, 1)) + b.abs().sum(dim=0)
    err = (out_k - out_t).abs()
    worst = float((err / scale).max())
    print(f"-- stream {label}: max|d|={float(err.max()):.3e} "
          f"max|d|/sum|x|={worst:.3e}")
    require(bool(torch.isfinite(out_k).all()) and worst <= 1e-5,
            f"stream kernel disagrees with its twin at {label}")
    return float(err.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import fastoptsolver_tpu_torch  # noqa: F401  (numerics contract)
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig, solve_lasso_batch
    from fastoptsolver_tpu_torch.batch.fista_gram import _rel_gap, make_gram_batch
    from fastoptsolver_tpu_torch.bench import stream as stream_mod
    from fastoptsolver_tpu_torch.bench.stream import measure_stream_ceiling, stream_pass_reference
    from fastoptsolver_tpu_torch.kernels import _build, fused_solve
    from fastoptsolver_tpu_torch.kernels.fused_solve import (
        fused_solve_reference, solve_lasso_fused)

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[1 device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s); "
          f"{len(regs)} kernels")
    for ln in regs:
        print(f"-- ptxas {ln}")

    # ---- 3: each kernel against its twin, on the card ----
    errs = {"fused": 0.0, "stream": 0.0}
    for i, (n, m, B) in enumerate(SMALL_SHAPES):
        A, b, a1 = small_problem(n, m, B, seed=i, device=dev)
        for mode, a2 in (("nesterov", 0.0), ("delta", 0.3)):
            cfg = BatchFISTAConfig(max_iter=1000, check_every=25,
                                   rel_gap_tol=1e-6, momentum=mode)
            res_k = solve_lasso_fused(A, b, a1, a2, cfg=cfg)
            torch.cuda.synchronize()
            res_t = fused_solve_reference(A, b, a1, a2, cfg=cfg)
            errs["fused"] = max(errs["fused"], compare_fused(
                res_k, res_t, cfg.check_every, f"{(n, m, B)} {mode}"))
        errs["stream"] = max(errs["stream"], compare_stream(A, b, str((n, m, B))))
    print("[3 kernel vs twin] small shapes ok")

    m = 1000
    A, b, alpha1 = bench_problem(BATCH, m, dev)
    torch.cuda.synchronize()
    cfg = BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)
    res_k = solve_lasso_fused(A, b, alpha1, 0.0, cfg=cfg)
    plain_ms, res_t = cuda_ms(lambda: fused_solve_reference(A, b, alpha1, 0.0, cfg=cfg))
    bench_dx, bench_dobj = compare_fused_bench(A, b, alpha1, res_k, res_t,
                                               cfg.check_every)
    del res_t
    errs["stream"] = max(errs["stream"], compare_stream(A, b, f"bench (5, {m}, {BATCH})"))
    stream_plain_ms, _ = cuda_ms(lambda: stream_pass_reference(A, b), reps=3)
    plan = fused_solve._plan(A, alpha1, 0.0, cfg, None, 1.02, None)
    kernel_ms = median([cuda_ms(lambda: fused_solve._launch(A, b, **plan))[0]
                        for _ in range(5)])  # the launch alone, no host set-up
    del plan
    torch.cuda.empty_cache()
    print("[3 kernel vs twin] bench shape ok")

    # ---- 4: the main path, counted ----
    fused_solve.LAUNCHES = 0
    stream_mod.LAUNCHES = 0
    res = solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)
    torch.cuda.synchronize()
    launches = {"fused": fused_solve.LAUNCHES}
    require(launches["fused"] == 1 and stream_mod.LAUNCHES == 0,
            f"main path: fused kernel launched {launches['fused']} times "
            f"(want 1), stream kernel {stream_mod.LAUNCHES} (want 0)")
    require(bool(torch.equal(res.x, res_k.x)), "main path result differs from the kernel's")
    n_conv = int(res.converged.sum())
    n_failed = int(res.failed.sum())
    max_gap = float(res.rel_gap.max())
    require(res.x.shape == (BATCH, 5) and bool(torch.isfinite(res.x).all()),
            "main path x is not finite of shape (B, 5)")
    require(n_conv == BATCH and n_failed == 0 and max_gap <= 1e-6,
            f"main path: {n_conv}/{BATCH} certified, {n_failed} failed, "
            f"max rel_gap {max_gap:.3e}")
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randperm(BATCH, generator=g, device=dev)[:4096]
    A64 = A[:, :, idx].double().permute(2, 1, 0)
    gb64 = make_gram_batch(A64, b[:, idx].double().T, alpha1[idx].double(), 0.0,
                           L=torch.ones(idx.numel(), dtype=torch.float64, device=dev))
    gap64 = float(_rel_gap(gb64, res.x[idx].double().T).max())
    del A64, gb64
    require(gap64 <= 1e-4, f"float64 recheck: max rel_gap {gap64:.3e} > 1e-4")
    stream_mod.LAUNCHES = 0
    ceil_first = measure_stream_ceiling(A, b, reps=3, trials=1)["stream_ceiling_gbps"]
    launches["stream"] = stream_mod.LAUNCHES
    require(launches["stream"] > 0, "the read-ceiling measurement launched no stream kernel")
    print(f"[4 main path] fused launches {launches['fused']}, certified "
          f"{n_conv}/{BATCH}, failed {n_failed}, max rel_gap {max_gap:.3e}, f64 "
          f"recheck max rel_gap {gap64:.3e} on 4096 lanes | read ceiling "
          f"{ceil_first:.1f} GB/s, stream launches {launches['stream']}")

    # ---- 5: times; these launches are not counted above ----
    solve_ms, ceil_gbps = [], []
    for _ in range(5):
        ceil_gbps.append(measure_stream_ceiling(A, b, reps=3, trials=1)["stream_ceiling_gbps"])
        ms, res = cuda_ms(lambda: solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg,
                                                    feature_major=True))
        solve_ms.append(ms)
        n_ok, n_bad = int(res.converged.sum()), int(res.failed.sum())
        require(n_ok == BATCH and n_bad == 0,
                f"timed solve: {n_ok}/{BATCH} certified, {n_bad} failed")
    t_solve = median(solve_ms) / 1e3
    ceil = median(ceil_gbps)
    bytes_in = (A.numel() + b.numel()) * A.element_size()
    stream_ms = bytes_in / (ceil * 1e9) * 1e3
    iters = res.iters.float()
    print(f"[5 times] solve {t_solve * 1e3:.3f} ms ({BATCH / t_solve:.4g} certified "
          f"instances/s) | stream ceiling {ceil:.1f} GB/s | pct_of_achievable "
          f"{100.0 * bytes_in / t_solve / 1e9 / ceil:.1f} | fused kernel alone "
          f"{kernel_ms:.3f} ms ({bytes_in / kernel_ms / 1e6:.1f} GB/s, "
          f"{100.0 * bytes_in / kernel_ms / 1e6 / ceil:.1f}% of the ceiling) | plain twin solve "
          f"{plain_ms:.1f} ms | plain read (torch sums) "
          f"{bytes_in / stream_plain_ms / 1e6:.1f} GB/s | iters median "
          f"{int(iters.median())} max {int(iters.max())} | solve ms trials "
          f"{[round(x, 3) for x in solve_ms]}")
    if plain_ms < t_solve * 1e3:
        print("-- the plain twin is faster than the kernel at this shape")

    kernels = [
        {"name": "fused_lasso_solve", "route": "cuda", "source": FUSED_SRC,
         "replaces": "fastoptsolver_tpu/kernels/fused_solve.py:120",
         "launches": launches["fused"], "max_abs_err": errs["fused"],
         "ms": kernel_ms, "plain_ms": plain_ms, "e2e_ms": t_solve * 1e3,
         "bench_max_abs_dx": bench_dx, "bench_max_rel_dobj": bench_dobj},
        {"name": "stream_ceiling", "route": "cuda", "source": STREAM_SRC,
         "replaces": "fastoptsolver_tpu/bench/stream.py:30",
         "launches": launches["stream"], "max_abs_err": errs["stream"],
         "ms": stream_ms, "plain_ms": stream_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
