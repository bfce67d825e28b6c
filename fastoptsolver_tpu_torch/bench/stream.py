"""No-math read ceiling of the fused kernel's inputs (port of
``fastoptsolver_tpu/bench/stream.py``).

``csrc/stream.cu`` reads every element of ``A (n, m, B)`` and ``b (m, B)``
once and writes each lane's full sum: ``b_tile`` threads per CTA, each
reading 4 adjacent lanes with 16-byte loads (B % 4 == 0 and 16-byte aligned
bases, ``stream_copy_bytes`` in C) or one lane with 4-byte loads; each
lane's sum is added in one order at either width. Its GB/s, measured in
the same process as the solve, is the denominator of ``pct_of_achievable``.
The TPU kernel touched one row per brick because its DMA moved whole bricks anyway;
a GPU fetches only what is read, so here every element is summed, and the
plain twin :func:`stream_pass_reference` computes the same full sum.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..kernels.fused_solve import B_TILE
from ..utils.profiling import launch


def stream_pass_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin: the per-lane sum of every element of A and b, (B,)."""
    return A.sum(dim=(0, 1)) + b.sum(dim=0)


def stream_pass(A: torch.Tensor, b: torch.Tensor,
                b_tile: int = B_TILE) -> torch.Tensor:
    """One read pass: launches ``stream_ceiling`` on a CUDA tensor, the
    plain twin on a CPU tensor. Returns the per-lane sums (B,)."""
    if not A.is_cuda:
        return stream_pass_reference(A, b)
    return _launch(A, b, b_tile)


@launch("stream")
def _launch(A: torch.Tensor, b: torch.Tensor, b_tile: int) -> torch.Tensor:
    """Launch ``stream_ceiling`` on the current stream."""
    n, m, B = A.shape
    _build.check_tensors((("A", A), ("b", b)))
    if b.shape != (m, B):
        raise ValueError(f"b {tuple(b.shape)} does not match A {tuple(A.shape)}")
    out = torch.empty((B,), dtype=A.dtype, device=A.device)
    _build.call("stream_ceiling", A.device, A, b, out, n, m, B, b_tile)
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
