"""fastoptsolver_tpu_torch — the PyTorch/CUDA port of ``fastoptsolver_tpu``.

A second package beside the JAX one, which stays the reference: every module
here keeps its JAX counterpart's name and surface, and the tests feed both
packages the same inputs. The slices ported so far are the certified
batched-lasso surface (``batch.solve_lasso_batch``, ``batch.solve_gram_batch``),
the regularization path and k-fold cross-validation built on it
(``batch.lasso_path``, ``batch.cv_lasso``), the single-problem solvers and
``solve``, the scikit-learn-style estimators (``Lasso``, ``ElasticNet``,
``Ridge``, ``MultiTaskLasso``, ``LassoCV``, ``ElasticNetCV``), every problem
family (``problems``: least squares and its Gram form, logistic, the
extensions, sparse CSR, Boston) and the generalized lasso
(``solvers.genlasso``); only the out-of-memory Gram reduction
(``problems.streaming``, ``solvers.gram_dense``) is still to come. Routing:
the torch Gram-form FISTA driver (``batch.fista_gram``) runs on any device; on
a CUDA tensor the router sends certified configurations with n ≤ 8, in every
momentum mode (fixed, adaptive restart, greedy, Armijo), to one launch of the
hand-written Hopper fused build+solve kernel (``kernels.fused_solve``), every
other configuration with n ≤ 104 to the two-kernel path (the Gram build
kernels, ``kernels.gram_build``, and the burst kernel,
``kernels.fista_vmem``), certified configurations
with 104 < n ≤ 168 to one launch of the resident kernel
(``kernels.resident``), and wider ones to the Q-streaming kernel
(``kernels.qstream``), one launch per burst. ``cv_lasso`` sends its
(folds + 1)·α grid through ``solve_gram_batch``, so on a CUDA tensor it
reaches the burst kernel at n ≤ 104 and the resident kernel up to n = 168;
``lasso_path`` runs the torch driver, as the reference does. ``LassoCV``
and ``ElasticNetCV`` call ``cv_lasso`` and so take its routing: on the card
their grid runs on the burst kernel at n ≤ 104 and the resident kernel to
n = 168; the plain estimators run ``solve`` (eager torch, no hand-written
kernel).

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

from . import batch, kernels, ops, problems, solvers  # noqa: E402
from .api import solve  # noqa: E402
from .estimators import (  # noqa: E402
    Lasso,
    ElasticNet,
    Ridge,
    LassoCV,
    ElasticNetCV,
    MultiTaskLasso,
)
from .batch import (  # noqa: E402
    BatchFISTAConfig,
    BatchResult,
    fista_gram_batch,
    make_gram_batch,
    solve_lasso_batch,
)
from .ops import (  # noqa: E402
    soft_threshold,
    prox_l1,
    prox_elastic_net,
    compute_objective,
    estimate_lipschitz,
)
from .problems import (  # noqa: E402
    LeastSquares,
    GramLeastSquares,
    LogisticRegression,
    CustomProblem,
    generate_boston_like,
    generate_scenario_batch,
    generate_scenario_batch_fm,
)
from .solvers import (  # noqa: E402
    ISTAConfig,
    FISTAConfig,
    ista,
    fista,
    fista_with_history,
    fista_delta_config,
)
