"""Host-side pieces of ``fastoptsolver_tpu/kernels/fista_vmem.py`` that the
fused kernel needs: the β table, the shared config guard and the Armijo
triple. The burst and adaptive kernels themselves are still to port
(ROADMAP Queue 2)."""
from __future__ import annotations

import numpy as np
import torch

from ..batch.fista_gram import BatchFISTAConfig


def _check_kernel_cfg(cfg: BatchFISTAConfig, backtracking_ok: bool = True) -> None:
    """Entry guard shared by the kernel paths: a config option a kernel does
    not implement fails loudly, never silently degrades to another algorithm
    (the torch driver, batch/fista_gram.py, implements everything)."""
    if cfg.backtracking and not backtracking_ok:
        raise NotImplementedError(
            "backtracking runs on the torch driver "
            "(batch.fista_gram.fista_gram_batch) — not on this kernel"
        )
    if cfg.adaptive_restart and cfg.momentum != "nesterov":
        raise ValueError("adaptive restart applies to nesterov momentum only")


def _armijo_static(cfg: BatchFISTAConfig):
    """Static (C, η, max_backtracks) triple for an in-kernel Armijo search,
    or None when the config doesn't backtrack."""
    if not cfg.backtracking:
        return None
    return (cfg.armijo_c, cfg.ls_eta, cfg.max_backtracks)


def momentum_betas(k0: int, n_steps: int, t0: float, cfg: BatchFISTAConfig):
    """Host-side β_k table for global iterations k0..k0+n_steps-1 plus the
    Nesterov scalar to resume from, built in numpy exactly as the reference
    builds it, as a CPU tensor; the caller copies it to the card once."""
    betas = np.empty(n_steps, np.float32)
    t = t0
    if cfg.momentum == "delta":
        for i in range(n_steps):
            k_ref = k0 + i + 1  # reference counts from 1
            betas[i] = k_ref / (k_ref + 1.0 + cfg.delta)
    else:
        for i in range(n_steps):
            t_next = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
            betas[i] = (t - 1.0) / t_next
            t = t_next
    return torch.from_numpy(betas), t
