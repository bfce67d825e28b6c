"""The build + solve pipeline per rank over a mesh's instance axis (port of
``fastoptsolver_tpu/kernels/pipeline.py``).

Every rank of ``mesh[axis]`` runs the whole single-device pipeline on its
own lanes, with no communication but the gather of the results: the fused
kernel (one launch, the Gram never in device memory) where its guards pass,
otherwise the two build kernels (``gram_build.make_gram_batch_fused``) and
the adaptive entry onto the resident kernel
(``fista_vmem.fista_gram_vmem_adaptive``). The routed surface
``batch.solve_lasso_batch(..., mesh=...)`` is the user's multi-device entry;
this module keeps the hand-wired pipeline for A/B comparison, as the
reference does.
"""
from __future__ import annotations

import torch

from ..batch.fista_gram import BatchFISTAConfig, BatchResult
from ..parallel.mesh import BATCH_AXIS
from .fista_vmem import LANE, fista_gram_vmem_adaptive
from .gram_build import make_gram_batch_fused


def solve_pipeline_sharded(
    A,  # (n, m, B) feature-leading
    b,  # (m, B)
    alpha1,
    alpha2,
    mesh,
    cfg: BatchFISTAConfig = BatchFISTAConfig(max_iter=1000, check_every=25),
    axis: str = BATCH_AXIS,
    b_tile_build: int = 256,
    b_tile_solve: int | None = None,
    interpret: bool = False,
) -> BatchResult:
    """Certified batched lasso over a mesh: per rank, the fused kernel or
    the build kernels and one adaptive solve launch. Every rank calls it
    with the whole batch (or DTensors sharded on the instance axis).
    Instances are zero-padded to a multiple of ``max(b_tile_build, 128)``
    lanes a rank (padded lanes have Q = c = 0 and certify at once); the
    results are gathered to every rank."""
    from ..parallel.lanes import LaneLayout
    from .fused_solve import _fits, solve_lasso_fused

    n, m, B = A.shape
    lay = LaneLayout(mesh, axis, B, max(b_tile_build, LANE))
    A_blk, b_blk = lay.take(A), lay.take(b)
    a1, a2 = lay.take_vector(alpha1, A_blk), lay.take_vector(alpha2, A_blk)
    if _fits(n, m, cfg):
        res = solve_lasso_fused(A_blk, b_blk, a1, a2, cfg=cfg, interpret=interpret)
    else:
        gb = make_gram_batch_fused(A_blk, b_blk, a1, a2, b_tile=b_tile_build,
                                   interpret=interpret)
        res = fista_gram_vmem_adaptive(gb, cfg, b_tile=b_tile_solve, interpret=interpret)
    x, iters, gap, converged, failed = (lay.gather(v, 0) for v in (
        res.x, res.iters, res.rel_gap, res.converged, res.failed))
    return BatchResult(x=x, iters=iters, rel_gap=gap, n_iters_total=torch.max(iters),
                       converged=converged, failed=failed)
