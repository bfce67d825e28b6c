"""Hand-written Hopper kernels and their plain PyTorch twins.

So far: ``fused_solve`` (CUDA ``csrc/fused_solve.cu``), the single-launch
build+solve of the main path. The CUDA sources are compiled on first use
(``_build``); importing this package needs no nvcc and no GPU."""
from .fused_solve import (
    auto_tiles_fused,
    fused_solve_reference,
    solve_lasso_fused,
)

__all__ = ["auto_tiles_fused", "fused_solve_reference", "solve_lasso_fused"]
