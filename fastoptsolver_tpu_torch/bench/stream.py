"""No-math read ceiling of the fused kernel's access pattern (port of
``fastoptsolver_tpu/bench/stream.py``).

``csrc/stream.cu`` reads every element of ``A (n, m, B)`` and ``b (m, B)``
with the fused kernel's launch shape (one thread per lane, ``b_tile`` lanes
per CTA) and writes each lane's full sum. Its GB/s, measured in the same
process as the solve, is the denominator of ``pct_of_achievable``. The TPU
kernel touched one row per brick because its DMA moved whole bricks anyway;
a GPU fetches only what is read, so here every element is summed, and the
plain twin :func:`stream_pass_reference` computes the same full sum.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..kernels.fused_solve import B_TILE

# Launches of the CUDA kernel by this process; incremented only where it launches.
LAUNCHES = 0


def stream_pass_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin: the per-lane sum of every element of A and b, (B,)."""
    return A.sum(dim=(0, 1)) + b.sum(dim=0)


def stream_pass(A: torch.Tensor, b: torch.Tensor,
                b_tile: int = B_TILE) -> torch.Tensor:
    """One read pass: launches ``stream_ceiling`` on a CUDA tensor, the
    plain twin on a CPU tensor. Returns the per-lane sums (B,)."""
    global LAUNCHES
    if not A.is_cuda:
        return stream_pass_reference(A, b)
    n, m, B = A.shape
    for name, t in (("A", A), ("b", b)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
    if b.shape != (m, B):
        raise ValueError(f"b {tuple(b.shape)} does not match A {tuple(A.shape)}")
    lib = _build.library()
    out = torch.empty((B,), dtype=A.dtype, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.stream_ceiling(A.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 n, m, B, b_tile, stream)
    _build.check(err, "stream_ceiling")
    LAUNCHES += 1
    return out


def measure_stream_ceiling(A: torch.Tensor, b: torch.Tensor,
                           b_tile: int = B_TILE, reps: int = 10,
                           trials: int = 3) -> dict:
    """Measured GB/s of the read pass over ``A``/``b`` on the card, timed
    with CUDA events over ``reps`` back-to-back launches, best of
    ``trials``. A device measurement: raises on a CPU tensor."""
    if not A.is_cuda:
        raise ValueError("measure_stream_ceiling times the CUDA kernel; "
                         "A is not a CUDA tensor")
    stream_pass(A, b, b_tile)  # warm
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            stream_pass(A, b, b_tile)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / 1e3 / reps)
    dt = min(times)
    gbytes = (A.numel() + b.numel()) * A.element_size() / 1e9
    return {"stream_ceiling_gbps": gbytes / dt, "stream_pass_s": dt,
            "b_tile": b_tile}
