"""Proximal operators (port of ``fastoptsolver_tpu/ops/prox.py``)."""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """L1 prox (soft thresholding): ``sign(v) * max(|v| - tau, 0)``.

    NaN propagates (``clamp_min`` keeps it), as ``jnp.maximum`` does, so the
    batched driver's non-finite quarantine still sees a diverged lane."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - tau, 0.0)
