"""The Lipschitz estimate of the torch Gram precompute in one launch (no
TPU kernel: the reference runs an XLA loop,
``fastoptsolver_tpu/batch/fista_gram.py:_batched_power_L``).

:func:`power_L` gives what ``batch.fista_gram._power_loop`` gives — v0
normalised, then per lane w = Q v, L = ‖w‖, v = w / max(L, 1e-30), stopped
before the first step at which no lane's L moved by ``tol`` or more, else
after ``n_iter`` steps — in two parts. First every step runs and each step's
L is kept in a history ``(n_iter, B)``: on a CUDA tensor one launch of the
hand-written kernel of ``csrc/lipschitz.cu`` (each lane's Gram in the shared
memory of a thread-block cluster of :func:`cluster_size` CTAs for all its
steps; see its note for the design and the bound), on a CPU tensor the plain
twin :func:`power_history_reference`. Then :func:`stop_step` finds, on the
history's device, the step the loop stops at, and the host reads that one
number (a ``fos.sync`` span; the ``power_steps`` counter adds it). Steps past
it were computed and are dropped: a batch whose lanes all settle in a few
steps still pays for all ``n_iter`` of them on the kernel, where the loop
would have stopped.

The kernel reads Q through its strides, as ``make_gram_batch``'s einsum
leaves it (each lane's Gram contiguous, lanes outermost). Its window is
1 ≤ n ≤ 664, where a CTA's slab fits a Hopper block at 8 CTAs a lane; the
C export behind :func:`cluster_size` is the one rule.
"""
from __future__ import annotations

import torch

from ..batch.fista_gram import _power_start, _power_step
from ..utils.profiling import count, launch, span
from . import _build


def cluster_size(n: int) -> int:
    """The kernel's cluster size at width ``n`` (``lipschitz_cluster_size``
    in C): 1, 2, 4 or 8 CTAs a lane, or 0 past its window, where the torch
    loop serves."""
    return _build.library().lipschitz_cluster_size(n)


def power_history_reference(Q: torch.Tensor, v0: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The plain twin of the kernel: every one of ``n_iter`` steps of the
    loop's recipe (its own step, ``_power_step``), the estimate of each step
    stacked into ``(n_iter, B)``."""
    v = _power_start(v0)
    hist = []
    for _ in range(n_iter):
        v, L = _power_step(Q, v)
        hist.append(L)
    if not hist:
        return Q.new_zeros((0, Q.shape[-1]))
    return torch.stack(hist)


def stop_step(hist: torch.Tensor, tol: float):
    """``(K, Ls)`` on ``hist``'s device, without a host read: ``Ls`` (n_iter
    + 1, B) the estimate before each step and after the last (zeros, then
    ``hist``), and K (0-d) the step count at which the loop stops: the first
    k < n_iter at which no lane moved, ``|Ls[k] − Ls[k − 1]| >= tol`` false
    for every lane (``Ls[−1]`` = inf, so NaN does not move), else n_iter.
    The loop returns ``Ls[K]``."""
    n_iter, B = hist.shape
    Ls = torch.cat((hist.new_zeros((1, B)), hist))
    prev = torch.cat((hist.new_full((1, B), float("inf")), Ls))
    still = torch.any(torch.abs(Ls[:n_iter] - prev[:n_iter]) >= tol, dim=1)
    # a stop appended after the last step: argmax finds the first stop
    stops = torch.cat((~still, still.new_ones((1,)))).to(torch.int32)
    return torch.argmax(stops), Ls


@launch("lipschitz")
def _launch(Q: torch.Tensor, v0: torch.Tensor, n_iter: int, cluster: int = 0) -> torch.Tensor:
    """``hist`` ``(n_iter, B)`` from ``lipschitz_power`` on the current
    stream; Q read through its own strides, v0 made contiguous. ``cluster``
    0 takes the kernel's rule; tests and timings force 1, 2, 4 or 8. Raises
    on an input the kernel does not take and on a launch error."""
    if Q.dim() != 3 or Q.shape[0] != Q.shape[1]:
        raise ValueError(f"Q must be (n, n, B), got {tuple(Q.shape)}")
    n, _, B = Q.shape
    v0 = v0.contiguous()
    _build.check_tensors((("v0", v0),))
    if not Q.is_cuda or Q.dtype != torch.float32 or Q.device != v0.device:
        raise ValueError(f"Q must be a float32 CUDA tensor on {v0.device}")
    if v0.shape != (n, B):
        raise ValueError(f"v0 {tuple(v0.shape)} does not match Q {tuple(Q.shape)}")
    hist = torch.empty((n_iter, B), dtype=Q.dtype, device=Q.device)
    _build.call("lipschitz_power", Q.device, Q, v0, hist, n, B, n_iter, *Q.stride(), cluster)
    return hist


def power_L(Q: torch.Tensor, v0: torch.Tensor, n_iter: int, tol: float) -> torch.Tensor:
    """λ_max(Q) per lane by the loop's recipe and stop: the kernel on a CUDA
    tensor (no launch for ``n_iter`` 0), the twin on a CPU tensor, then
    :func:`stop_step` and one host read of the step count."""
    if Q.is_cuda and n_iter > 0:
        hist = _launch(Q, v0, n_iter)
    else:
        hist = power_history_reference(Q, v0, n_iter)
    K, Ls = stop_step(hist, tol)
    with span("fos.sync"):
        k = int(K)
    count("power_steps", k)
    return Ls[k]
