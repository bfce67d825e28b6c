"""fastoptsolver_tpu_torch — the PyTorch/CUDA port of ``fastoptsolver_tpu``.

A second package beside the JAX one, which stays the reference: every module
here keeps its JAX counterpart's name and surface, and the tests feed both
packages the same inputs. The slice ported so far is the certified
batched-lasso main path (``batch.solve_lasso_batch``): the torch Gram-form
FISTA driver (``batch.fista_gram``) runs on any device, and on a CUDA tensor
the router sends fixed-momentum configurations to one launch of the
hand-written Hopper fused build+solve kernel (``kernels.fused_solve``).

The package imports no JAX, and nothing that needs ``nvcc``, Triton or a GPU:
CUDA kernels are compiled on first use (``kernels._build``).
"""

__version__ = "0.1.0"

import os as _os

import torch as _torch

# Numerics contract (the counterpart of fastoptsolver_tpu/__init__.py:27-44):
# certified solves need true f32 contractions. TF32 keeps ~10 mantissa bits —
# the same class of fault as the TPU's bf16 MXU default, which floored the
# duality gap at ~4e-2. torch links ``allow_tf32`` and the matmul precision,
# so a precision other than "highest" here means the user chose it before
# this import, and that choice is kept. FOS_MATMUL_PRECISION is an on/off
# switch here: "default" leaves torch's settings alone, and any other value
# (the JAX package also takes "bfloat16" etc.) keeps this contract.
if (_os.environ.get("FOS_MATMUL_PRECISION", "highest") != "default"
        and _torch.get_float32_matmul_precision() == "highest"):
    _torch.backends.cuda.matmul.allow_tf32 = False
    _torch.backends.cudnn.allow_tf32 = False
    _torch.set_float32_matmul_precision("highest")

from . import batch, kernels, ops, problems  # noqa: E402
from .batch import (  # noqa: E402
    BatchFISTAConfig,
    BatchResult,
    fista_gram_batch,
    make_gram_batch,
    solve_lasso_batch,
)
from .ops import soft_threshold  # noqa: E402
from .problems import generate_scenario_batch_fm  # noqa: E402
