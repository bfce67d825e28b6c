"""Large dense-matrix lasso benchmark (port of
``fastoptsolver_tpu/bench/large_lasso.py``): one design matrix (default
131072 × 2048, 1 GiB of float32) solved by the port's dense ``fista`` on
raw ``(A, b)``; n = 2048 > 128, so ``solve`` would not take the Gram form
either. Each iteration is two matvecs, ``A@y`` and ``Aᵀr``, each reading A
once, so the streaming bound is 2·(A's bytes) an iteration over the card's
3.35 TB/s (0.64 ms at the default shape). The Lipschitz estimate is made
once before the timed solves and timed apart (the reference times it inside
the solve and counts its largest number of power steps toward the bytes;
here the bytes are exactly the solve's).

The data are made on the device from a ``torch.Generator``. On a CUDA
device the solve is timed with CUDA events (best of 3), and the read
ceiling of ``bench/stream.py`` is measured in the same process over A's
bytes: A's elements viewed as ``(8, rows, 262144)``, 8 feature planes (the
stream kernel's most) of the headline bench's 262144 lanes (the kernel
gives a thread 4 lanes, so it wants many), beside a ``(rows, 262144)``
zero b. On a
CPU tensor the host clock times it and the ceiling's fields are null.

CLI (one JSON line, on the card):
    python -m fastoptsolver_tpu_torch.bench.large_lasso [--m 131072] [--n 2048] [--iters 200]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import torch

PEAK_BYTES_PER_S = 3.35e12  # the H100 SXM's data-sheet memory rate
STREAM_PLANES, STREAM_LANES = 8, 262144  # A viewed as (8, rows, lanes) for the ceiling


class LargeLassoRun(NamedTuple):
    record: dict  # the JSON record
    problem: object  # the float32 LeastSquares that was solved
    x: torch.Tensor  # the timed solve's solution


def build(m: int, n: int, generator: torch.Generator, alpha1_scale: float = 0.1):
    """``(A, b, alpha1)`` in float32 on ``generator``'s device: A ~ N(0, 1/n),
    a 5%-sparse x_true with N(0, 9) entries, noise 0.1, α₁ = scale·‖Aᵀb‖∞."""
    dev = generator.device
    A = torch.randn((m, n), generator=generator, device=dev) / n ** 0.5
    keep = torch.rand((n,), generator=generator, device=dev) < 0.05
    x_true = torch.where(keep, 3.0 * torch.randn((n,), generator=generator, device=dev), 0.0)
    b = A @ x_true + 0.1 * torch.randn((m,), generator=generator, device=dev)
    return A, b, alpha1_scale * torch.amax(torch.abs(A.T @ b))


def _timed(fn, on_cuda: bool):
    """(seconds of one call of ``fn``, its result): CUDA events on the card,
    the host clock on the CPU."""
    if on_cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def run(m: int = 131072, n: int = 2048, iters: int = 200, alpha1_scale: float = 0.1,
        seed: int = 0, device=None) -> LargeLassoRun:
    """Time ``fista`` on the large lasso (best of 3, after one warm call);
    return the record with the problem and the best call's solution.
    ``device`` defaults to the card."""
    from ..ops.lipschitz import lipschitz_for
    from ..problems import LeastSquares
    from ..solvers import FISTAConfig, fista

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    A, b, alpha1 = build(m, n, gen, alpha1_scale)
    problem = LeastSquares(A=A, b=b, alpha1=alpha1, alpha2=A.new_zeros(()))
    cfg = FISTAConfig(max_iter=iters)
    lip_s, L = _timed(lambda: lipschitz_for(problem, torch.Generator(device=device)
                                            .manual_seed(seed)), on_cuda)
    solve = lambda: fista(problem, cfg, L=L)
    res = solve()  # warm
    best, res = min((_timed(solve, on_cuda) for _ in range(3)), key=lambda t: t[0])

    matvecs = 2 * iters
    a_bytes = A.numel() * A.element_size()
    bytes_read = matvecs * a_bytes
    bound_s_per_iter = 2 * a_bytes / PEAK_BYTES_PER_S
    rec = {
        "m": m, "n": n, "iters": iters, "seconds": best, "lipschitz_seconds": lip_s,
        "L": float(L), "iters_per_s": iters / best, "ms_per_iter": best / iters * 1e3,
        "a_bytes": a_bytes, "matvecs": matvecs, "bytes_read": bytes_read,
        "achieved_gbps": bytes_read / best / 1e9,
        "achieved_tflops": matvecs * 2.0 * m * n / best / 1e12,
        "bound_ms_per_iter": bound_s_per_iter * 1e3,
        "pct_of_bound": bound_s_per_iter * iters / best * 100.0,
        "stream_ceiling_gbps": None, "pct_of_ceiling": None,
        "objective": float(problem.objective(res.x)),
        "nnz_frac": float(torch.mean((torch.abs(res.x) > 0).to(torch.float32))),
        "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
    }
    rows, rem = divmod(m * n, STREAM_PLANES * STREAM_LANES)
    if on_cuda and rows and not rem:
        from .stream import measure_stream_ceiling

        A_lanes = A.view(STREAM_PLANES, rows, STREAM_LANES)
        ceil = measure_stream_ceiling(A_lanes, A.new_zeros((rows, STREAM_LANES)))
        rec["stream_ceiling_gbps"] = ceil["stream_ceiling_gbps"]
        rec["pct_of_ceiling"] = rec["achieved_gbps"] / ceil["stream_ceiling_gbps"] * 100.0
    return LargeLassoRun(rec, problem, res.x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--m", type=int, default=131072)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.m, args.n, args.iters).record))


if __name__ == "__main__":
    main()
