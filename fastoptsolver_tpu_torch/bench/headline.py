"""Headline benchmark of the port (counterpart of the root ``bench.py``):
batched lasso instances solved to a 1e-6 relative gap per second on one card.

The bench configuration (n=5, m=1000, B=262144; ``BENCH_BATCH`` overrides B),
data made on the card from seed 0 by :func:`build_problems`, solved through
the public routed surface ``solve_lasso_batch`` (fixed Nesterov momentum,
``check_every=25``, ``rel_gap_tol=1e-6``, ``max_iter=1000``), which on a
CUDA tensor is one launch of the fused build+solve kernel. The pipeline timed
is everything from raw ``(A, b, α₁)`` to certified solutions, data
generation excluded.

The read ceiling (``bench/stream.py``) is measured in the same process,
interleaved with the solve trials, and ``pct_of_achievable`` divides the
solve's input bytes per second by it. Each solve is timed alone with CUDA
events and a sync, so its time includes the host set-up around the launch;
the fused kernel's launch alone is timed too, and ``host_setup_ms`` is the
difference. ``bytes_out`` is ``(n + 3)·B·4`` (x, iters, gap, done): the
port pads no n.

Prints exactly one JSON line. A device measurement: raises without a CUDA
device.

Usage (repo root, on a machine with a GPU):
  python -m fastoptsolver_tpu_torch.bench.headline
  BENCH_BATCH=65536 python -m fastoptsolver_tpu_torch.bench.headline
"""
from __future__ import annotations

import json
import os

import torch

METRIC = "batched_lasso_instances_solved_to_1e-6_rel_gap_per_s"
BATCH, M = 262144, 1000


def build_problems(generator: torch.Generator, batch: int, m: int):
    """The bench configuration's data (``bench.py:_build_problems``) on
    ``generator``'s device, feature-leading: per-instance noise/ρ drawn from
    the reference grid, the ported generator, features standardised per
    instance, α₁ = 0.1·‖Aᵀb‖∞. Returns ``A (5, m, batch)``, ``b (m, batch)``
    and ``alpha1 (batch,)``; torch's generator gives other numbers than
    ``jax.random`` from the same seed."""
    from ..problems import generate_scenario_batch_fm

    device = generator.device
    pick = lambda vals: torch.tensor(vals, device=device)[
        torch.randint(len(vals), (batch,), generator=generator, device=device)]
    noise, rho1, rho2 = pick([0.5, 1.0, 2.0, 5.0]), pick([0.5, 0.8]), pick([0.7, 0.9])
    A, b, _ = generate_scenario_batch_fm(generator, batch, m=m, noise_std=noise,
                                         rho1=rho1, rho2=rho2)
    mu = A.mean(dim=1, keepdim=True)
    sd = A.std(dim=1, keepdim=True, unbiased=False)
    A.sub_(mu).div_(sd)
    alpha1 = 0.1 * torch.stack([(A[k] * b).sum(0) for k in range(A.shape[0])]).abs().amax(0)
    return A, b, alpha1


def bench_config():
    from ..batch.fista_gram import BatchFISTAConfig

    return BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


def solve(A, b, alpha1, cfg):
    """The pipeline timed: the public routed call on feature-leading data."""
    from ..batch import solve_lasso_batch

    return solve_lasso_batch(A, b, alpha1, 0.0, cfg=cfg, feature_major=True)


def _event_ms(fn):
    """(ms of one call of ``fn`` from CUDA events, synchronised, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def kernel_ms(A, b, alpha1, cfg, reps: int = 5) -> float:
    """Median ms of the fused kernel's launch alone (no host set-up) over
    ``reps`` launches, each timed with CUDA events."""
    from ..kernels import fused_solve

    plan = fused_solve._plan(A, alpha1, 0.0, cfg, None, 1.02, None)
    times = sorted(_event_ms(lambda: fused_solve._launch(A, b, **plan))[0]
                   for _ in range(reps))
    return times[len(times) // 2]


def measure(A, b, alpha1, cfg, reps: int = 25, trials: int = 3,
            ceiling_reps: int = 10, beside=None) -> dict:
    """``trials`` rounds, each: one read-ceiling measurement over
    ``ceiling_reps`` launches, ``beside`` (a callable timed the same way,
    if given), then ``reps`` solves, each timed alone. Returns every
    trial's per-solve ms, the ceilings (GB/s), ``beside``'s ms, the fewest
    certified lanes and the most failed lanes of any timed solve, and the
    last result."""
    from .stream import measure_stream_ceiling

    trial_ms, ceilings, beside_ms = [], [], []
    n_conv, n_failed, res = None, 0, None
    for _ in range(trials):
        ceilings.append(measure_stream_ceiling(A, b, reps=ceiling_reps,
                                               trials=1)["stream_ceiling_gbps"])
        if beside is not None:
            beside_ms.append(_event_ms(beside)[0])
        ms = []
        for _ in range(reps):
            t, res = _event_ms(lambda: solve(A, b, alpha1, cfg))
            ms.append(t)
            c = int(res.converged.sum())
            n_conv = c if n_conv is None else min(n_conv, c)
            n_failed = max(n_failed, int(res.failed.sum()))
        trial_ms.append(ms)
    return {"trial_ms": trial_ms, "ceilings_gbps": ceilings, "beside_ms": beside_ms,
            "converged": n_conv, "failed": n_failed, "result": res}


def record(shape, meas: dict, kernel_ms: float, device: str, power_limit: str) -> dict:
    """The JSON record from a :func:`measure` run on ``A`` of ``shape``
    (n, m, B), as ``bench.py`` reports it: the best trial's mean per-solve
    time and the best ceiling; no TPU constant."""
    n, m, batch = shape
    dt = min(sum(ms) / len(ms) for ms in meas["trial_ms"]) / 1e3
    ceil = max(meas["ceilings_gbps"])
    bytes_in = (n * m + m) * batch * 4
    bytes_out = (n + 3) * batch * 4
    res = meas["result"]
    value = meas["converged"] / dt
    return {
        "metric": METRIC,
        "value": value,
        "unit": "instances/s",
        "vs_baseline": value / 1e4,
        "detail": {
            "batch": batch, "m": m, "n": n,
            "converged": meas["converged"], "failed": meas["failed"],
            "lockstep_iters": int(res.n_iters_total),
            "median_iters": int(res.iters.float().median()),
            "solve_s": dt,
            "bytes_in": bytes_in, "bytes_out": bytes_out,
            "achieved_gbps": (bytes_in + bytes_out) / dt / 1e9,
            "stream_ceiling_gbps": ceil,
            # input bytes on both sides: the ceiling counts only its A+b reads
            "pct_of_achievable": 100.0 * (bytes_in / dt / 1e9) / ceil,
            "trial_ms": meas["trial_ms"],
            "ceilings_gbps": meas["ceilings_gbps"],
            "kernel_ms": kernel_ms,
            "host_setup_ms": dt * 1e3 - kernel_ms,
            "device": device, "power_limit": power_limit,
        },
    }


def main() -> None:
    import fastoptsolver_tpu_torch  # noqa: F401  (numerics contract: no TF32)
    from .stream import measure_stream_ceiling
    from .wide_n import _power_limit

    if not torch.cuda.is_available():
        raise RuntimeError("the headline measures the card; no CUDA device is visible")
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = int(os.environ.get("BENCH_BATCH", BATCH))
    A, b, alpha1 = build_problems(torch.Generator(device=dev).manual_seed(0), batch, M)
    cfg = bench_config()
    solve(A, b, alpha1, cfg)  # warm: the β table, the library
    measure_stream_ceiling(A, b, reps=1, trials=1)
    meas = measure(A, b, alpha1, cfg)
    k_ms = kernel_ms(A, b, alpha1, cfg)
    print(json.dumps(record(tuple(A.shape), meas, k_ms, torch.cuda.get_device_name(dev),
                            _power_limit())))


if __name__ == "__main__":
    main()
