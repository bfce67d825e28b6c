"""Hand-written Hopper kernels and their plain PyTorch twins.

- ``fused_solve`` (CUDA ``csrc/fused_solve.cu``): the single-launch
  build+solve of the main path, every mode, resumable (``FusedSolveState``);
- ``gram_build`` (CUDA ``csrc/gram_build.cu``) and ``fista_vmem`` (CUDA
  ``csrc/fista_burst.cu``): the two-kernel path, the Gram build and the
  certified burst engine;
- ``resident`` (CUDA ``csrc/resident.cu``): the whole certified solve in one
  launch with each group's Gram on-chip, 104 < n ≤ 168, and the adaptive
  entry ``fista_vmem.fista_gram_vmem_adaptive``;
- ``qstream`` (CUDA ``csrc/qstream.cu``): bursts past the resident window,
  each lane's Q held in a thread-block cluster's shared memory for the burst
  (n ≤ 660), else streamed from device memory at every step;
- ``lipschitz`` (CUDA ``csrc/lipschitz.cu``): the torch Gram precompute's
  power estimate of L, every step in one launch with each lane's Gram in a
  cluster's shared memory (n ≤ 664), one host read for the loop's stop;
- over a ``torch.distributed`` mesh, per rank on its lanes:
  ``fista_vmem.fista_gram_vmem_sharded`` (the burst engine) and
  ``pipeline.solve_pipeline_sharded`` (the fused kernel, or the build
  kernels and the adaptive entry).

The CUDA sources are compiled on first use (``_build``); importing this
package needs no nvcc and no GPU."""
from .fista_vmem import (
    VmemSolveState,
    auto_b_tile,
    fista_gram_vmem,
    fista_gram_vmem_adaptive,
    fista_gram_vmem_sharded,
    momentum_betas,
    plan_gram_solve,
)
from .fused_solve import (
    FusedSolveState,
    auto_tiles_fused,
    fused_solve_reference,
    solve_lasso_fused,
)
from .gram_build import make_gram_batch_fused
from .pipeline import solve_pipeline_sharded
from .qstream import auto_tiles_qstream, qstream_burst
from .resident import (
    ResidentSolveState,
    auto_b_tile_resident,
    fista_gram_resident,
    fista_gram_resident_reference,
)

__all__ = [
    "FusedSolveState",
    "ResidentSolveState",
    "VmemSolveState",
    "auto_b_tile",
    "auto_b_tile_resident",
    "auto_tiles_fused",
    "auto_tiles_qstream",
    "fista_gram_resident",
    "fista_gram_resident_reference",
    "fista_gram_vmem",
    "fista_gram_vmem_adaptive",
    "fista_gram_vmem_sharded",
    "fused_solve_reference",
    "make_gram_batch_fused",
    "momentum_betas",
    "plan_gram_solve",
    "qstream_burst",
    "solve_lasso_fused",
    "solve_pipeline_sharded",
]
