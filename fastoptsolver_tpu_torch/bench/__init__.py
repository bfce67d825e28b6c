"""Measurement helpers (port of ``fastoptsolver_tpu.bench``): the reference's
80-scenario sweep (``sweep``, whose four entry points this package exports
as the reference's does), the kernel verification against the torch driver
(``verify_tpu``), the stream ceiling, the wide-n bench and the headline bench
(``bench.py``'s measurement)."""
from .sweep import run_sweep, suboptimality, plot_scenario, build_scenarios

__all__ = ["run_sweep", "suboptimality", "plot_scenario", "build_scenarios"]
