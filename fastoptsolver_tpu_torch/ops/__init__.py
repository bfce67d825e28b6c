"""Elementwise operators (port of ``fastoptsolver_tpu.ops``; prox only so far)."""
from .prox import soft_threshold

__all__ = ["soft_threshold"]
