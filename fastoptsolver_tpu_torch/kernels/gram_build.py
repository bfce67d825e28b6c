"""Index helpers from ``fastoptsolver_tpu/kernels/gram_build.py``.

Only ``_pairs`` and ``_round_up`` are ported so far; the two-kernel path's
build kernel (``_gram_tile_kernel``) is still to port (ROADMAP Queue 2)."""
from __future__ import annotations


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pairs(na: int):
    """Upper-triangle index pairs of the (na, na) augmented Gram, row-major:
    the accumulator row of pair (i, k) is ``p = i·na − i(i−1)/2 + (k − i)``."""
    return [(i, k) for i in range(na) for k in range(i, na)]
