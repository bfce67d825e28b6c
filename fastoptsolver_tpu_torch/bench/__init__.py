"""Measurement helpers (port of ``fastoptsolver_tpu.bench``; the stream
ceiling so far)."""
