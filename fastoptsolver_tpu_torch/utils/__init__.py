"""Checkpoints and profiling (port of ``fastoptsolver_tpu.utils``)."""
from .checkpoint import save_pytree, restore_pytree
from .profiling import trace, timed, solver_stats

__all__ = ["save_pytree", "restore_pytree", "trace", "timed", "solver_stats"]
