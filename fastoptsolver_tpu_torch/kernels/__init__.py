"""Hand-written Hopper kernels and their plain PyTorch twins.

- ``fused_solve`` (CUDA ``csrc/fused_solve.cu``): the single-launch
  build+solve of the main path;
- ``gram_build`` (CUDA ``csrc/gram_build.cu``) and ``fista_vmem`` (CUDA
  ``csrc/fista_burst.cu``): the two-kernel path, the Gram build and the
  certified burst engine.

The CUDA sources are compiled on first use (``_build``); importing this
package needs no nvcc and no GPU."""
from .fista_vmem import (
    VmemSolveState,
    auto_b_tile,
    fista_gram_vmem,
    momentum_betas,
    plan_gram_solve,
)
from .fused_solve import (
    auto_tiles_fused,
    fused_solve_reference,
    solve_lasso_fused,
)
from .gram_build import make_gram_batch_fused

__all__ = [
    "VmemSolveState",
    "auto_b_tile",
    "auto_tiles_fused",
    "fista_gram_vmem",
    "fused_solve_reference",
    "make_gram_batch_fused",
    "momentum_betas",
    "plan_gram_solve",
    "solve_lasso_fused",
]
