"""Measurement helpers (port of ``fastoptsolver_tpu.bench``): the stream
ceiling, the wide-n bench and the headline bench (``bench.py``'s
measurement)."""
