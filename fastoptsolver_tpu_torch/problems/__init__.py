"""Problem generators (port of ``fastoptsolver_tpu.problems``; the
feature-leading batch generator so far)."""
from .generators import X_TRUE, generate_scenario_batch_fm

__all__ = ["X_TRUE", "generate_scenario_batch_fm"]
