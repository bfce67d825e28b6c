"""The Gram build of the two-kernel path (port of
``fastoptsolver_tpu/kernels/gram_build.py``).

:func:`make_gram_batch_fused` turns feature-leading ``A (n, m, B)``,
``b (m, B)`` and α into a :class:`GramBatch`: ``Q = AᵀA`` (both triangles),
``c = Aᵀb``, ``bᵀb`` and the per-lane Lipschitz bound ``L``. On a CUDA tensor
it launches the hand-written Hopper kernels of ``csrc/gram_build.cu`` — two
launches, ``gram_pairs`` (one pass over A and b, staged through a ring of
three shared-memory stages filled by ``cp.async`` so the loads overlap the
sums) and ``gram_power`` (the power iteration against each lane's Gram held
in shared memory, on the resident kernel's layout: features on threads,
:func:`power_group_lanes` lanes a CTA, and its matvec,
``csrc/tri_matvec.cuh``); see the source's note for their design and
bounds. On a CPU tensor it runs the plain twin :func:`gram_build_reference`,
built from ``_common.augmented_gram`` and ``_common.power_lambda_max``:
v0 = c, 32 steps at n ≤ 7, else 96, and the host rule
``L = where(λ > 0, 1.02·λ, 1) + α₂``.

The build has two windows, chosen by whether it estimates L: with power
steps 1 ≤ n ≤ :data:`MAX_N` (118); without them (``pl_iters=0``, the
resident route, whose kernel estimates L itself) 1 ≤ n ≤
:data:`PAIRS_MAX_N`, the resident engine's window (168).

The reference's TPU tiling knobs ``b_tile``, ``m_tile`` and ``split_k`` have no
counterpart: the kernels tile lanes themselves and each lane's sums do not
depend on the tiling.
"""
from __future__ import annotations

import torch

from ..batch.fista_gram import GramBatch, _lane_vector
from ..utils.profiling import launch
from . import _build
from ._common import augmented_gram, make_matvec, power_lambda_max
from .resident import MAX_N as PAIRS_MAX_N

# Shared memory a Hopper block may opt into (H100: 227 KB).
SMEM_PER_BLOCK = 232448
# Lanes per CTA of gram_pairs (csrc/gram_build.cu kLanes): one 128-byte line
# per feature and row, copied as eight 16-byte or thirty-two 4-byte pieces.
LANE_TILE = 32
# gram_pairs' ring of shared-memory stages (kStages), each 8 rows × 32
# features × LANE_TILE lanes of f32 (32 KB): copies of two stages in flight
# while the third is summed.
PAIRS_STAGES = 3


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pairs(na: int):
    """Upper-triangle index pairs of the (na, na) augmented Gram, row-major:
    the accumulator row of pair (i, k) is ``p = i·na − i(i−1)/2 + (k − i)``."""
    return [(i, k) for i in range(na) for k in range(i, na)]


def _pairs_smem_bytes() -> int:
    """Shared memory of ``gram_pairs``' ring (the C function
    ``gram_pairs_smem_bytes``): 96 KB, so two CTAs fit on an SM."""
    return PAIRS_STAGES * 8 * 32 * LANE_TILE * 4


def _pairs_work(n: int, m: int, B: int) -> dict:
    """What ``gram_pairs`` must do at ``(n, m, B)``: ``bytes``, A and b read
    once and Q, c and bᵀb written once; ``flops``, two per distinct pair sum
    of the augmented Gram and row; and ``l2_bytes``, what its CTAs copy from
    L2. Each of the nb(nb+1)/2 block pairs of a lane tile stages its two
    16-feature blocks, so each block is staged nb + 1 times; copies of
    padded features, rows past m and lanes past B read nothing. 32.3 GB at
    n=96, m=192, B=54144."""
    nb = -(-(n + 1) // 16)
    return {"bytes": 4 * (n * m * B + m * B + n * n * B + n * B + B),
            "flops": B * m * (n + 1) * (n + 2),
            "l2_bytes": 4 * (nb + 1) * (n + 1) * m * B}


# Threads a CTA and lanes a CTA at most of ``gram_power`` (csrc/gram_build.cu
# kPMaxThreads, kPMaxGroup); its norm takes n <= 128 (kPMaxN).
POWER_MAX_THREADS = 1024
POWER_MAX_GROUP = 32
POWER_MAX_N = 128


def _power_lane_bytes(n: int) -> int:
    """Shared memory of one ``gram_power`` lane: its iterate and its squares,
    ``round_up(n, 4)`` floats each, and its Gram's upper triangle."""
    return (2 * _round_up(n, 4) + n * (n + 1) // 2) * 4


def power_group_lanes(n: int) -> int:
    """Lanes per CTA of ``gram_power`` on an H100 at feature count n
    (1 ≤ n ≤ 128): as many as 227 KB of shared memory and 1024 threads
    (``round_up(n, 32)`` a lane) hold, at most 32; 10 at n = 96, 8 at 118.
    The rule of ``resident.group_lanes`` on ``gram_power``'s own bytes; the
    card's is the C export ``gram_power_group``."""
    if not 1 <= n <= POWER_MAX_N:
        raise ValueError(f"gram_power takes n = 1..{POWER_MAX_N}, got n={n}")
    return min(POWER_MAX_GROUP, POWER_MAX_THREADS // _round_up(n, 32),
               SMEM_PER_BLOCK // _power_lane_bytes(n))


def _power_smem_bytes(n: int) -> int:
    """Shared memory of a ``gram_power`` CTA of :func:`power_group_lanes`
    lanes on an H100 (the C function ``gram_power_smem_bytes``)."""
    return power_group_lanes(n) * _power_lane_bytes(n)


# The window of the build with power steps, 1 <= n <= 118: where gram_power's
# first layout, 8 lanes' triangles a CTA, fit 227 KB. Its block holds lanes past
# it now, but the window routes the callers that estimate L on the host side
# (the burst engine's, the precompute's) and is kept where it was. gram_pairs
# alone (pl_iters = 0) takes the resident engine's window, PAIRS_MAX_N: its
# ring and grid hold any n.
MAX_N = 118


def _auto_tiles(n: int, m: int, pl_iters: int | None = None):
    """``(b_tile, m_tile)`` of the Hopper build: 32 lanes per CTA and the
    whole row axis in the block's own loop. The window is 1 ≤ n ≤ ``MAX_N``
    (118; the burst engine needs n ≤ 104) with power steps, and 1 ≤ n ≤
    ``PAIRS_MAX_N`` (168) for ``gram_pairs`` alone (``pl_iters == 0``).
    Raises past it, with a pointer to the torch precompute, as the reference
    raises past its VMEM budget."""
    if pl_iters == 0:
        hi, build = PAIRS_MAX_N, "Gram build without power steps (pl_iters=0)"
    else:
        hi, build = MAX_N, "fused Gram build"
    if not 1 <= n <= hi:
        raise ValueError(
            f"{build}: n={n} is past its window (n <= {hi}). Use the torch "
            "precompute (batch.make_gram_batch) for wider problems."
        )
    return LANE_TILE, m


def gram_build_reference(A: torch.Tensor, b: torch.Tensor, pl_iters: int):
    """The plain twin of the two kernels on a tensor of any device:
    ``(Q (n, n, B), c (n, B), btb (B,), lam (B,))``, λ the power-iteration
    estimate from v0 = c (no safety factor, no α₂)."""
    n = A.shape[0]
    Q, c, btb = augmented_gram(A, b)
    lam = power_lambda_max(make_matvec(Q, n), c, pl_iters)
    return Q.contiguous(), c.contiguous(), btb[0], lam[0]


def _launch(A: torch.Tensor, b: torch.Tensor, pl_iters: int):
    """Launch ``gram_pairs`` then, unless ``pl_iters`` is 0, ``gram_power``
    on the current stream; the same outputs as :func:`gram_build_reference`. Raises on any input the
    kernels do not take and on a launch error."""
    Q, c, btb = _launch_pairs(A, b)
    if pl_iters == 0:  # no power steps: λ = 0, as the twin's
        return Q, c, btb, torch.zeros((A.shape[2],), dtype=A.dtype, device=A.device)
    return Q, c, btb, _launch_power(Q, c, pl_iters)


@launch("gram_pairs")
def _launch_pairs(A: torch.Tensor, b: torch.Tensor):
    """``(Q, c, btb)`` from ``gram_pairs`` on the current stream."""
    n, m, B = A.shape
    _build.check_tensors((("A", A), ("b", b)))
    if b.shape != (m, B):
        raise ValueError(f"b {tuple(b.shape)} does not match A {tuple(A.shape)}")
    _auto_tiles(n, m, 0)
    Q = torch.empty((n, n, B), dtype=A.dtype, device=A.device)
    c = torch.empty((n, B), dtype=A.dtype, device=A.device)
    btb = torch.empty((B,), dtype=A.dtype, device=A.device)
    _build.call("gram_pairs", A.device, A, b, Q, c, btb, n, m, B)
    return Q, c, btb


@launch("gram_power")
def _launch_power(Q: torch.Tensor, c: torch.Tensor, pl_iters: int) -> torch.Tensor:
    """λ (B,) from ``gram_power`` on the (n, n, B) Gram and c (n, B) that
    ``gram_pairs`` wrote, on the current stream."""
    _build.check_tensors((("Q", Q), ("c", c)))
    n, _, B = Q.shape
    lam = torch.empty((B,), dtype=Q.dtype, device=Q.device)
    _build.call("gram_power", Q.device, Q, c, lam, n, B, pl_iters)
    return lam


def make_gram_batch_fused(
    A: torch.Tensor,  # (n, m, B) feature-leading
    b: torch.Tensor,  # (m, B)
    alpha1,
    alpha2,
    pl_iters: int | None = None,
    l_safety: float = 1.02,
    b_tile: int | None = None,
    m_tile: int | None = None,
    interpret: bool = False,
    split_k: int = 4,
) -> GramBatch:
    """The two build kernels on a CUDA tensor, their plain twin on a CPU
    tensor; ``interpret=True`` asks for the twin and raises with a CUDA
    tensor. ``pl_iters`` defaults to 32 at n ≤ 7, else 96; ``L =
    where(λ > 0, l_safety·λ, 1) + α₂`` (a lane with c = 0 has λ = 0 and
    x* = 0). ``pl_iters=0`` builds the pairs alone (λ = 0, so L = 1 + α₂)
    and takes n ≤ ``PAIRS_MAX_N`` (168); with power steps n ≤ ``MAX_N``
    (118). ``b_tile``, ``m_tile`` and ``split_k`` are the reference's TPU
    knobs and select nothing here; ``split_k < 1`` still raises."""
    del b_tile, m_tile
    if A.dim() != 3:
        raise ValueError("A must be (n, m, B)")
    n, m, B = A.shape
    if split_k < 1:
        raise ValueError(f"split_k must be >= 1 (got {split_k})")
    _auto_tiles(n, m, pl_iters)
    if pl_iters is None:
        pl_iters = 32 if n <= 7 else 96
    _build.refuse_interpret(interpret, A.is_cuda)
    run = _launch if A.is_cuda else gram_build_reference
    Q, c, btb, lam = run(A, b, pl_iters)
    a1 = _lane_vector(alpha1, B, A)
    a2 = _lane_vector(alpha2, B, A)
    L = torch.where(lam > 0.0, l_safety * lam, torch.ones_like(lam)) + a2
    return GramBatch(Q=Q, c=c, btb=btb, alpha1=a1, alpha2=a2, L=L)
