"""The native host runtime and the scenario loader (port of
``fastoptsolver_tpu.runtime``)."""
from .host import (
    ScenarioLoader,
    ensure_built,
    native_available,
    generate_scenarios_host,
    standardize_host,
    gram_batch_host,
)

__all__ = [
    "ScenarioLoader",
    "ensure_built",
    "native_available",
    "generate_scenarios_host",
    "standardize_host",
    "gram_batch_host",
]
