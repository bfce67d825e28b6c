"""The routed batched-lasso surface (port of the routing in
``fastoptsolver_tpu/batch/api.py``: ``_kernel_route`` and
``solve_lasso_batch``).

Routing follows the reference's "guards decide" rule: the fused kernel's own
guards (``_check_fused_cfg`` + ``auto_tiles_fused``) say what the kernel
route can take, so the router cannot drift from the kernel.

- **Kernel route** — taken when ``A`` is a CUDA tensor (the reference's
  ``jax.default_backend() == "tpu"``) or ``interpret=True``, and the guards
  pass: one launch of the fused CUDA kernel on a CUDA tensor, its plain twin
  on a CPU tensor under ``interpret``. ``interpret=True`` with a CUDA tensor
  raises.
- **Torch driver** (``make_gram_batch`` + ``fista_gram_batch``) — everything
  else under ``backend="auto"``; always under ``backend="xla"`` (the
  reference's name for "force the driver", kept for the same meaning).
- ``backend="kernel"`` raises with the guard's message when the kernel route
  cannot serve the call, including a CPU tensor without ``interpret``.

Until the fused kernel learns them, adaptive restart, greedy momentum and
Armijo backtracking on CUDA go to the torch driver, as do n above the
kernel's envelope (ROADMAP Queue 1 item 4). ``mesh``, ``state0`` and
``return_state`` are not ported yet.
"""
from __future__ import annotations

import torch

from .fista_gram import BatchFISTAConfig, fista_gram_batch, make_gram_batch


def _default_cfg() -> BatchFISTAConfig:
    return BatchFISTAConfig(max_iter=1000, check_every=25, rel_gap_tol=1e-6)


def _kernel_route(n: int, m: int, cfg, backend: str, interpret: bool,
                  on_cuda: bool):
    """Can/should this (n, m, cfg) run on the fused kernel? Returns
    ``(use_kernel, reason_if_not)``; raises under ``backend="kernel"`` when
    the answer is no, with the guard's message."""
    if backend not in ("auto", "kernel", "xla"):
        raise ValueError(f"Unknown backend '{backend}'")
    if backend == "xla":
        return False, "backend='xla'"
    from ..kernels.fused_solve import _check_fused_cfg, auto_tiles_fused

    try:
        _check_fused_cfg(cfg)
        auto_tiles_fused(n, m)
    except (ValueError, NotImplementedError) as e:
        if backend == "kernel":
            raise ValueError(f"backend='kernel' unsupported here: {e}") from e
        return False, str(e)
    if interpret and on_cuda:
        raise ValueError("interpret=True runs the plain twin on a CPU tensor; "
                         "A is a CUDA tensor")
    if on_cuda or interpret:
        return True, None
    reason = "not a CUDA tensor (pass interpret=True to run the plain twin)"
    if backend == "kernel":
        raise ValueError(f"backend='kernel' unsupported here: {reason}")
    return False, reason


def solve_lasso_batch(
    A,
    b,
    alpha1,
    alpha2=0.0,
    cfg=None,
    backend: str = "auto",
    feature_major: bool = False,
    key: torch.Generator | None = None,
    interpret: bool = False,
    state0=None,
    return_state: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
):
    """One call from raw ``(A, b, α)`` to certified batched lasso solutions,
    routed as the module docstring says.

    ``feature_major``: inputs are ``A (n, m, B), b (m, B)`` (the native
    layout, no transpose); otherwise ``A (B, m, n), b (B, m)``. ``key`` is
    the ``torch.Generator`` for the driver's power-iteration start (the
    reference takes a ``jax.random`` key there). Returns a ``BatchResult``."""
    if mesh is not None or mesh_axis is not None:
        raise NotImplementedError(
            "solve_lasso_batch(mesh=) is not ported yet (ROADMAP Queue 1 "
            "item 9: torch.distributed)"
        )
    if state0 is not None or return_state:
        raise NotImplementedError(
            "checkpoint/resume through solve_lasso_batch is not ported yet "
            "(ROADMAP Queue 1 item 4: FusedSolveState and the resume dispatch)"
        )
    if cfg is None:
        cfg = _default_cfg()
    n = A.shape[0] if feature_major else A.shape[-1]
    m = A.shape[1]

    use_kernel, _ = _kernel_route(n, m, cfg, backend, interpret, A.is_cuda)
    if use_kernel:
        from ..kernels.fused_solve import solve_lasso_fused

        A_fm = A if feature_major else A.permute(2, 1, 0)
        b_fm = b if feature_major else b.T
        return solve_lasso_fused(A_fm.contiguous(), b_fm.contiguous(), alpha1,
                                 alpha2, cfg=cfg, interpret=interpret)

    A_im = A.permute(2, 1, 0) if feature_major else A
    b_im = b.T if feature_major else b
    gb = make_gram_batch(A_im, b_im, alpha1, alpha2, generator=key)
    return fista_gram_batch(gb, cfg)
