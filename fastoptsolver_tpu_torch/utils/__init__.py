"""Checkpoints and profiling (port of ``fastoptsolver_tpu.utils``), and the
program's spans and counters."""
from .checkpoint import save_pytree, restore_pytree
from .profiling import counters, reset_counters, solver_stats, span, spans, timed, trace

__all__ = ["save_pytree", "restore_pytree", "trace", "timed", "solver_stats", "span", "spans",
           "counters", "reset_counters"]
